"""Matrix ensembles: the input stacks, drawn on the device from the seed.

A configuration file names its ensemble; :func:`draw` makes a cell's pool
of distinct stacks with one ``torch.Generator`` on the device, in a few
large calls and in the precision the configuration states.  The same seed
gives the same stacks.
"""

import torch

DTYPES = {"float64": torch.float64, "float32": torch.float32}


def spiked_wigner(config: dict, b: int, gen: torch.Generator,
                  device) -> torch.Tensor:
    """``b`` matrices ``W + sum_i theta_i u_i u_i^T`` of size ``n``.

    ``W`` is symmetric Gaussian with off-diagonal variance ``1/n`` (bulk
    edge at 2; Johnstone 2001), the ``u_i`` are an orthonormal frame from
    the QR of a Gaussian ``(n, spikes)`` block, and the ``theta_i`` are
    evenly spaced over ``config["theta"]``.  Each ``theta > 1`` puts an
    outlier near ``theta + 1/theta`` (Baik, Ben Arous and Peche 2005).
    """
    n, r = int(config["n"]), int(config["spikes"])
    dtype = DTYPES[config["precision"]]
    g = torch.randn((b, n, n), generator=gen, dtype=dtype, device=device)
    a = (g + g.transpose(-1, -2)) * (0.5 / n) ** 0.5
    del g
    u, _ = torch.linalg.qr(torch.randn((b, n, r), generator=gen, dtype=dtype,
                                       device=device))
    lo, hi = config["theta"]
    theta = torch.linspace(lo, hi, r, dtype=dtype, device=device)
    spikes = (u * theta) @ u.transpose(-1, -2)
    a += 0.5 * (spikes + spikes.transpose(-1, -2))
    return a


ENSEMBLES = {"spiked_wigner": spiked_wigner}


def draw(config: dict, traffic: dict, seed: int, device) -> list:
    """The cell's pool: ``traffic["pool"]`` stacks of ``traffic["b"]``
    matrices, all from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    make = ENSEMBLES[config["ensemble"]]
    return [make(config, int(traffic["b"]), gen, device)
            for _ in range(int(traffic["pool"]))]
