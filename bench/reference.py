"""The plain reference and the comparisons that decide ``correct``.

Plain PyTorch: ``torch.linalg.eigh`` in float64 of the benchmark's own
input stacks, on whatever device they lie.  It imports nothing of the
program and takes nothing the program made; it reads the program's outputs
only to judge them.  Every comparison returns one number per matrix.
"""

import torch


def _eigh(stack: torch.Tensor):
    return torch.linalg.eigh(stack.to(torch.float64))


def solve(stack: torch.Tensor) -> dict:
    """Eigenvalues ``(b, n)`` ascending and the table ``mags (b, n, n)``
    with ``mags[b, i, j] = |v_i[j]|^2`` (a row per eigenvector)."""
    lam, v = _eigh(stack)
    return {"lam": lam, "mags": (v * v).transpose(-1, -2),
            "scale": lam.abs().amax(dim=-1)}


def topk(stack: torch.Tensor, k: int, largest: bool = True) -> dict:
    """The ``k`` extremal eigenvalues ``(b, k)`` ascending and their unit
    eigenvectors ``vecs (b, k, n)`` (a row per eigenvector)."""
    lam, v = _eigh(stack)
    sel = slice(-k, None) if largest else slice(0, k)
    return {"lam": lam[:, sel], "vecs": v[:, :, sel].transpose(-1, -2),
            "scale": lam.abs().amax(dim=-1)}


def eig_err(lam: torch.Tensor, ref: dict) -> torch.Tensor:
    """Largest eigenvalue error of each matrix over its spectral norm."""
    gap = (lam.to(torch.float64) - ref["lam"]).abs().amax(dim=-1)
    return gap / ref["scale"]


def mag_err(mags: torch.Tensor, ref: dict) -> torch.Tensor:
    """Largest L1 distance of a row of ``|v_i[j]|^2`` (each row sums to 1)
    from the reference's row, per matrix."""
    diff = (mags.to(torch.float64) - ref["mags"]).abs().sum(dim=-1)
    return diff.amax(dim=-1)


def vec_err(vecs: torch.Tensor, ref: dict) -> torch.Tensor:
    """Largest 2-norm distance of a signed unit vector from the
    reference's, under the one sign an eigenvector is free to take, per
    matrix."""
    v = vecs.to(torch.float64)
    flip = torch.where((v * ref["vecs"]).sum(dim=-1, keepdim=True) < 0,
                       -1.0, 1.0)
    dist = torch.linalg.vector_norm(v - flip * ref["vecs"], dim=-1)
    return dist.amax(dim=-1)
