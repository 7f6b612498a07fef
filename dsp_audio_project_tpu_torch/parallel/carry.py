"""The cross-shard IIR carry of the sharded chain and the sharded stream.

Each block shard runs the EQ's grouped recurrence from a zero state and
exposes its end state e_b (d values a channel).  One all-gather of those
states over the block axis (``collectives.py``) and host tables built in
float64 give shard b its true incoming state

    sigma0_b = sum_{s<b} A_shard^{b-1-s} e_s + A_shard^b sigma_in,

where A_shard = (A^block)^K_loc spans one shard and sigma_in is the
stream's incoming carry (zero for the one-shot chain, ``pipeline.py``);
the carry folds into the shard's block states through (A^block)^k and K9
reads out and clips.  The JAX package computes the same algebra twice
(``parallel/pipeline.py:243``, ``streaming.py:710-740``); here both
callers share this module.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..ops import eq as eq_ops


def cross_shard_tables(state_corr, nb: int, K_loc: int) -> dict:
    """The carry's host tables for ``nb`` block shards of ``K_loc`` blocks,
    powered in float64 from A^block = ``state_corr`` (float32 powers lose
    precision over many blocks), the JAX package's values:

    * ``pk`` (K_loc, d, d): (A^block)^k, a shard's incoming state onto its
      block k;
    * ``pow_nb`` (nb + 1, d, d): A_shard^k;
    * ``weights`` (nb, nb, d, d), float32: W[dst, src] = A_shard^{dst-1-src}
      below the diagonal;
    * ``w_out`` (nb, d, d): A_shard^{nb-1-i}, the outgoing carry's weights.

    The caller rounds to float32 as it uploads."""
    A_blk = np.asarray(state_corr, np.float64)
    d = A_blk.shape[0]
    A_shard = np.linalg.matrix_power(A_blk, K_loc)
    pow_nb = np.zeros((nb + 1, d, d))
    acc = np.eye(d)
    for k in range(nb + 1):
        pow_nb[k] = acc
        acc = acc @ A_shard
    weights = np.zeros((nb, nb, d, d), dtype=np.float32)
    for dst in range(nb):
        for src in range(dst):
            weights[dst, src] = pow_nb[dst - 1 - src]
    pk = np.zeros((K_loc, d, d))
    acc = np.eye(d)
    for k in range(K_loc):
        pk[k] = acc
        acc = acc @ A_blk
    return {"pk": pk, "pow_nb": pow_nb, "weights": weights,
            "w_out": np.stack([pow_nb[nb - 1 - i] for i in range(nb)])}


def shard_end(e: torch.Tensor, t: dict):
    """A shard's zero-state carry from its block end states e (..., K, d):
    (sigma_local (..., K, d), the state entering each block, and e_shard
    (..., d), the state leaving the shard)."""
    sigma_local = eq_ops._carry_states(e, t["state_corr"], t.get("carry_w"))
    e_shard = sigma_local[..., -1, :] @ t["state_corr"].T + e[..., -1, :]
    return sigma_local, e_shard


def cross_shard(sigma_local: torch.Tensor, gathered: torch.Tensor,
                sigma_in: torch.Tensor, b: int, t: dict) -> torch.Tensor:
    """Block shard b's true per-block states from its local carries
    ``sigma_local`` (..., K, d), its row's gathered shard-end states
    (nb, ..., d) and the row's incoming carry (..., d).  At nb = 1,
    weights = 0 and pow_nb[0] = I, so sigma0 = sigma_in."""
    sigma0 = (torch.einsum("sij,s...j->...i", t["weights"][b], gathered)
              + sigma_in @ t["pow_nb"][b].T)
    return sigma_local + torch.einsum("kij,...j->...ki", t["pk"], sigma0)


def finish_row(axis, staged: Sequence, tabs: Sequence[dict],
               sigma_in: torch.Tensor):
    """One channel row's carry and readout.  ``staged[i]`` = (y0, s_in,
    sigma_local, e_shard) of the row's i-th local shard (block
    ``axis.blocks[i]``), ``tabs[i]`` its device's tables; ``sigma_in`` the
    row's incoming carry, on any device.  Returns (z of each local shard,
    clipped, through K9; the gathered end states of each)."""
    gathered = axis.all_gather([st[3] for st in staged])
    zs: List[torch.Tensor] = []
    for i, (b, (y0, s_in, sigma_local, _), t) in enumerate(
            zip(axis.blocks, staged, tabs)):
        sigma = cross_shard(sigma_local, gathered[i],
                            sigma_in.to(sigma_local.device), b, t)
        zs.append(eq_ops._grouped_finish(y0, s_in, sigma, t))
    return zs, gathered
