"""Faults planted in the program underneath a run, which the comparison
has to refuse: its tests plant each, and ``control.py --fault`` reads one
on the card at a cell's own size.

- ``stuck_lambda``: a step that returns its state unchanged: the per-SNP
  lambda search hands back lambda = 1, where it would start;
- ``stale_basis``: a step that returns its state unchanged: the program's
  eigenbasis cache takes every kinship for the one it holds;
- ``half_block``: half of the batch left out: each streamed block's (or a
  rank's share's) second half of SNPs is replaced by its first half;
- ``altered_beta``: an answer altered where it is produced: every block's
  beta leaves the association step 1% off;
- ``ml_tau``: an answer altered where the table is made: tau takes the ML
  degrees of freedom n where GEMMA's REML tau takes n - c - 1;
- ``no_exchange``: the exchange between cards left out: every rank's
  gather of the table hands back its own shares in place of the other
  ranks' (a multi-card cell's fault; it changes nothing without a mesh).
"""

from __future__ import annotations

import contextlib

NAMES = ("stuck_lambda", "stale_basis", "half_block", "altered_beta",
         "ml_tau", "no_exchange")


def _patches(name: str) -> list:
    """(object, attribute, replacement) of fault ``name``."""
    import torch

    from pygemma_tpu_torch import api
    from pygemma_tpu_torch.core import assoc

    if name == "stuck_lambda":
        real = assoc.solve_lambda

        def stuck(prob, cfg):
            lam, lik = real(prob, cfg)
            return torch.ones_like(lam), lik

        return [(assoc, "solve_lambda", stuck)]
    if name == "stale_basis":
        return [(api, "_kinship_fingerprint", lambda K, *a: "one kinship")]
    if name == "half_block":
        class Halved(api.SnpBlockStreamer):
            def __iter__(self):
                for start, stop, xb in super().__iter__():
                    # a rank of a mesh gets its share of the block
                    h = min(stop - start, xb.shape[1]) // 2
                    xb = xb.clone()
                    xb[:, h:2 * h] = xb[:, :h]
                    yield start, stop, xb

        return [(api, "SnpBlockStreamer", Halved)]
    if name == "altered_beta":
        def altered(real):
            def step(*args, **kw):
                stacked = real(*args, **kw)
                stacked[0] *= 1.01  # the beta row
                return stacked
            return step

        return [(api, f, altered(getattr(api, f)))
                for f in ("_assoc_block", "_assoc_multi")]
    if name == "ml_tau":
        real_frame = api._frame

        def frame(out, n, c, tests, pheno=None):
            out = dict(out, tau=out["tau"] * (n / (n - c - 1)))
            return real_frame(out, n, c, tests, pheno)

        return [(api, "_frame", frame)]
    if name == "no_exchange":
        import torch.distributed as dist

        from pygemma_tpu_torch.parallel import distributed

        def own(t):
            return [t.cpu().numpy()] * dist.get_world_size()

        return [(distributed, "all_gather", own)]
    raise ValueError(f"unknown fault {name!r}")


@contextlib.contextmanager
def plant(name: str):
    patches = _patches(name)
    saved = [(obj, attr, getattr(obj, attr)) for obj, attr, _ in patches]
    for obj, attr, fake in patches:
        setattr(obj, attr, fake)
    try:
        yield
    finally:
        for obj, attr, real in saved:
            setattr(obj, attr, real)
