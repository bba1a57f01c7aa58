"""Inputs made from the seed: the frozen tables and the weights on the device
(one ``torch.Generator`` there, a few large draws), the positives and the
scoring requests on the host (the program takes them as host arrays and
lists).  Both the program and the reference are handed these same objects.

The tables have ``build_frozen_tables``' shapes and dtypes: per-chromosome
feature tables (n_c, n_c) in the configuration's table dtype (corrcoef-like
values in [-1, 1], ones on the diagonal), the attribute table (N + 1, C + 1)
f32 (one-hot chromosome and the coordinate over the first chromosome's bin
count), ``inter_z`` (N + 1, N + f_max) in the table dtype (z-score-like
normals; row 0 and the f_max pad columns the Trainer would add are zero), the
chromosome of each id and the chromosomes' id ranges.  The weights are the
published model's tree (reference ``Code/Modules.py``) in the port's
``(in, out)`` layout: linear layers U(+-1/sqrt(fan_in)), the attention
projections N(0, 2 / (d_model + d_k)), LayerNorms ones and zeros.
"""

from __future__ import annotations

import math
import sys
import time
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from portbench.reference.layout import Layout


class Clock:
    """Set-up phases' seconds on standard error (the device synchronised
    at each lap, so each phase's device work is its own)."""

    def __init__(self):
        self.t = time.perf_counter()

    def lap(self, what: str) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        print(f"setup {what}: {now - self.t:.3f} s", file=sys.stderr,
              flush=True)
        self.t = now


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit seed for sub-stream ``stream`` of the run's seed."""
    return int(np.random.SeedSequence([int(seed) % 2**63, stream])
               .generate_state(2, np.uint32).view(np.uint64)[0] >> 1)


def generator(device, seed: int, stream: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed_of(seed, stream))


class Tables(NamedTuple):
    features: Tuple[torch.Tensor, ...]
    attr_table: torch.Tensor
    inter_z: torch.Tensor
    chrom_of_node: torch.Tensor
    chrom_bounds: torch.Tensor


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def make_tables(lay: Layout, table_dtype: torch.dtype, device,
                seed: int) -> Tables:
    gen = generator(device, seed, 1)
    sq = [b * b for b in lay.bins]
    flat = torch.rand(sum(sq), generator=gen, device=device)
    flat = flat.mul_(2.0).sub_(1.0).to(table_dtype)
    feats, off = [], 0
    for b, n in zip(lay.bins, sq):
        f = flat[off:off + n].view(b, b)
        f.fill_diagonal_(1.0)
        feats.append(f)
        off += n
    N, C = lay.n_nodes, lay.n_chroms
    chrom = torch.as_tensor(lay.chrom_of_node(), device=device)
    first = torch.as_tensor(np.asarray(lay.starts), device=device)
    attr = torch.zeros((N + 1, C + 1), device=device)
    ids = torch.arange(1, N + 1, device=device)
    attr[ids, chrom[1:]] = 1.0
    attr[ids, C] = (ids - first[chrom[1:]]).float() / float(lay.bins[0])
    inter = torch.randn((N + 1, N + lay.f_max), generator=gen,
                        device=device, dtype=table_dtype)
    inter[0].zero_()
    inter[:, N:].zero_()
    bounds = torch.as_tensor(
        np.stack([lay.starts, np.add(lay.starts, lay.bins)], axis=1)
        .astype(np.int32), device=device)
    return Tables(tuple(feats), attr, inter, chrom.to(torch.int32), bounds)


def _linear(w, b=None) -> Dict:
    return {"w": w} if b is None else {"w": w, "b": b}


def _ln(d: int, device) -> Dict:
    return {"g": torch.ones(d, device=device),
            "b": torch.zeros(d, device=device)}


def make_params(lay: Layout, model: dict, device, seed: int) -> Dict:
    """The weight tree, drawn in two calls (one uniform, one normal) and
    cut into leaves."""
    d, H = int(model["d_model"]), int(model["n_head"])
    dk, dv = int(model["d_k"]), int(model["d_v"])
    C = lay.n_chroms
    # (shape, fan_in) of every uniform leaf, in the order they are cut
    shapes: List[Tuple[Tuple[int, ...], int]] = []
    for b in lay.bins:
        shapes += [((b, d), b), ((d, d), d)]                 # ae w1, w2
    for b in lay.bins:
        shapes += [((d, b), d), ((b,), d)]                   # recon w, b
    shapes += [((C + 1, d), C + 1), ((d,), C + 1)]         # attr_nn
    shapes += [((d, d), d), ((d,), d)]                     # next_w
    shapes += [((H * dv, d), H * dv), ((d,), H * dv)]      # fc1
    shapes += [((d, d), d), ((d,), d)] * 2                 # pff_n1
    shapes += [((d, 1), d), ((1,), d)]                     # classifier
    gen = generator(device, seed, 2)
    total = sum(math.prod(s) for s, _ in shapes)
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    leaves, off = [], 0
    for s, fan in shapes:
        n = math.prod(s)
        # a leaf of its own (aligned as the kernels require), not a view
        leaves.append(u[off:off + n].view(s).mul(1.0 / math.sqrt(fan)))
        off += n
    z = torch.randn(3 * d * H * dk, generator=gen, device=device)
    std_qk = math.sqrt(2.0 / (d + dk))
    std_v = math.sqrt(2.0 / (d + dv))
    wq, wk, wv = (z[i * d * H * dk:(i + 1) * d * H * dk].view(d, H * dk)
                  * s for i, s in enumerate((std_qk, std_qk, std_v)))
    it = iter(leaves)
    ae = [{"w1": next(it), "w2": next(it)} for _ in lay.bins]
    recon = [_linear(next(it), next(it)) for _ in lay.bins]
    attr_nn = _linear(next(it), next(it))
    next_w = {"layers": [_linear(next(it), next(it))]}
    fc1 = _linear(next(it), next(it))
    pff_n1 = {"layers": [_linear(next(it), next(it)),
                         _linear(next(it), next(it))],
              "ln": _ln(d, device)}
    classifier = {"layers": [_linear(next(it), next(it))]}
    return {
        "embed": {"ae": ae, "recon": recon},
        "attr_nn": attr_nn,
        "next_w": next_w,
        "encoder": {"mha": {"ln_q": _ln(d, device), "ln_k": _ln(d, device),
                            "ln_v": _ln(d, device), "wq": wq, "wk": wk,
                            "wv": wv, "fc1": fc1},
                    "pff_n1": pff_n1},
        "ln_dynamic": _ln(d, device),
        "ln_static": _ln(d, device),
        "pff_classifier": classifier,
    }


def positives(lay: Layout, ks, per_k: int, seed: int):
    """{k: (edges (per_k, k) int32 sorted distinct rows of distinct nodes
    anywhere on the genome, weights (per_k,) f32 in [0.5, 1.5))}."""
    rng = np.random.default_rng([int(seed) % 2**63, 3])
    out = {}
    for k in ks:
        e = np.sort(rng.integers(1, lay.n_nodes + 1, (3 * per_k, k)), axis=1)
        e = e[(np.diff(e, axis=1) > 0).all(axis=1)]
        e = np.unique(e, axis=0)
        e = e[rng.permutation(len(e))[:per_k]]
        if len(e) < per_k:
            raise ValueError(f"drew {len(e)} distinct rows of k={k}, "
                             f"wanted {per_k}")
        out[int(k)] = (e.astype(np.int32),
                       (rng.random(per_k) + 0.5).astype(np.float32))
    return out


def requests(lay: Layout, ks, per_k: int, pool: int, seed: int):
    """``pool`` scoring requests, each a shuffled list of per_k candidates
    of each k: k distinct sorted bins of one chromosome, the chromosome
    drawn in proportion to its bins."""
    rng = np.random.default_rng([int(seed) % 2**63, 4])
    p = np.asarray(lay.bins, np.float64) / lay.n_nodes
    out = []
    for _ in range(pool):
        rows = []
        for k in ks:
            got = np.zeros((0, k), np.int64)
            while len(got) < per_k:
                c = rng.choice(lay.n_chroms, 2 * per_k, p=p)
                off = np.sort(rng.random((2 * per_k, k)), axis=1)
                loc = np.floor(off * np.asarray(lay.bins)[c, None]).astype(
                    np.int64)
                ok = (np.diff(loc, axis=1) > 0).all(axis=1)
                got = np.concatenate(
                    [got, (loc + np.asarray(lay.starts)[c, None])[ok]])
            rows += got[:per_k].tolist()
        out.append([rows[i] for i in rng.permutation(len(rows))])
    return out
