"""Plain PyTorch linear algebra of the port: Householder reduce and Sturm
bisection."""
