"""What the harness places on the program's entry points, and takes off again.

``Probes`` (the ``--trace 1`` run): a ``record_function`` range
``portbench:<op>:<i>`` and the call's shapes around the attention forward
(``models.modules.hyperedge_attention``, the name ``modules.py`` calls it
by), the attention backward (``ops.hyperedge_attention._FusedAttention
.backward``) and the table gather's gradient (``ops.table_scatter
._TableGather.backward``); host seconds and a range around the sampler
(``train.runtime._sample_all_negatives``, looked up when it is called).

``Recorder`` (set-up of a training cell): for the first ``n`` steps of the
Trainer it keeps what the reference follows and judges: each step's rows
and negatives, weights and fallback count (from ``_sample_all_negatives``),
its dropout uniforms in draw order (``models.modules.rand``, also under
``models.hypersagnn``'s name), its recon chromosome
(``models.hypersagnn._recon_chrom``), its loss parts and its predictions
(the step's aux), the first gradient's
norm per leaf from AdamW's state after step 1, and each leaf's change after
step n.  The values the program computes pass through unchanged.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List

import torch

from portbench.reference.model import named_leaves


def launch_counts() -> Dict[str, int]:
    """The program's own kernel launch counters (each wrapper adds one
    where it launches its kernel)."""
    from matcha_tpu_torch.ops import fused_tail as ft
    from matcha_tpu_torch.ops import hyperedge_attention as ha
    from matcha_tpu_torch.ops import propose as pp
    from matcha_tpu_torch.ops import table_scatter as ts
    return {"K1": ha.hyperedge_attention.launches,
            "K2": ha.hyperedge_attention_bwd_cuda.launches,
            "K3": ts.scatter_add.launches, "K4": ts.bincount.launches,
            "K5": pp.propose_phase1.launches,
            "K6_fwd": ft.fused_tail_fwd_cuda.launches,
            "K6_bwd": ft.fused_tail_bwd_cuda.launches}


def launches_per(before: Dict[str, int], units: int) -> Dict[str, float]:
    after = launch_counts()
    return {k: (after[k] - before[k]) / max(units, 1) for k in after}


class Patch:
    """setattr with the old value kept; ``undo`` puts every one back."""

    def __init__(self):
        self._old: List[tuple] = []

    def set(self, obj, name: str, value) -> None:
        self._old.append((obj, name, obj.__dict__[name]
                          if isinstance(obj, type) else getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        for obj, name, old in reversed(self._old):
            setattr(obj, name, old)
        self._old.clear()


def _attn_call(x, wq, n_head) -> dict:
    E, L, d = x.shape
    return {"E": int(E), "L": int(L), "d": int(d), "hd": int(wq.shape[1]),
            "elem": x.element_size(),
            "dtype": "bfloat16" if x.dtype == torch.bfloat16 else "float32"}


class Probes:
    def __init__(self):
        self.calls: Dict[str, List[dict]] = defaultdict(list)
        self.sampler_s: List[float] = []
        self._patch = Patch()

    def _ranged(self, op: str, call: dict):
        call["i"] = len(self.calls[op])
        self.calls[op].append(call)
        return torch.profiler.record_function(f"portbench:{op}:{call['i']}")

    def install(self) -> "Probes":
        from matcha_tpu_torch.models import modules
        from matcha_tpu_torch.ops import hyperedge_attention as ha
        from matcha_tpu_torch.ops import table_scatter as ts
        from matcha_tpu_torch.train import runtime
        fwd = modules.hyperedge_attention
        bwd = ha._FusedAttention.__dict__["backward"].__func__
        gbwd = ts._TableGather.__dict__["backward"].__func__
        sample = runtime._sample_all_negatives

        def attn_fwd(x, ln, wq, wk, wv, fw, fb, n_head, diag_mask=True):
            with self._ranged("attn_fwd", _attn_call(x, wq, n_head)):
                return fwd(x, ln, wq, wk, wv, fw, fb, n_head, diag_mask)

        def attn_bwd(ctx, g):
            x, _, wq = ctx.saved_tensors[:3]
            with self._ranged("attn_bwd", _attn_call(x, wq, ctx.n_head)):
                return bwd(ctx, g)

        def scatter_bwd(ctx, g):
            call = {"T": int(g.shape[0]), "d": int(g.shape[1]),
                    "n": int(ctx.n_rows), "elem": g.element_size(),
                    "dtype": "bfloat16" if g.dtype == torch.bfloat16
                    else "float32"}
            with self._ranged("scatter", call):
                return gbwd(ctx, g)

        def sampler(*a, **kw):
            with self._ranged("sampler", {}):
                t0 = time.perf_counter()
                out = sample(*a, **kw)
                self.sampler_s.append(time.perf_counter() - t0)
            return out

        p = self._patch
        p.set(modules, "hyperedge_attention", attn_fwd)
        p.set(ha._FusedAttention, "backward", staticmethod(attn_bwd))
        p.set(ts._TableGather, "backward", staticmethod(scatter_bwd))
        p.set(runtime, "_sample_all_negatives", sampler)
        return self

    def remove(self) -> None:
        self._patch.undo()


class Recorder:
    """Wraps ``trainer.train_step`` for the first ``n`` steps; see the
    module docstring.  ``steps`` holds one dict per step."""

    def __init__(self, trainer, params0, n: int = 3):
        self.trainer, self.params0, self.n = trainer, params0, n
        self.steps: List[dict] = []
        self.first_grad: Dict[str, torch.Tensor] = {}
        self.change: Dict[str, torch.Tensor] = {}
        self._patch = Patch()
        self._cur: dict = {}

    def install(self) -> "Recorder":
        from matcha_tpu_torch.models import hypersagnn, modules
        from matcha_tpu_torch.train import runtime
        rand, recon_chrom = modules.rand, hypersagnn._recon_chrom
        sample = runtime._sample_all_negatives
        step = self.trainer.train_step
        b1 = self.trainer.optimizer.defaults["betas"][0]

        def rec_rand(gen, shape, device):
            u = rand(gen, shape, device)
            self._cur["draws"].append(u.clone())
            return u

        def rec_recon_chrom(dims, generator, r):
            r = recon_chrom(dims, generator, r)
            self._cur["r"] = int(r)
            return r

        def rec_sample(table, blooms, settings, batch, generator, ns=1):
            xs, ws, fb = sample(table, blooms, settings, batch, generator, ns)
            self._cur.update(
                xs={k: v.clone() for k, v in xs.items()},
                ws={k: v.clone() for k, v in ws.items()},
                n_pos={k: int(batch[k][0].shape[0]) for k in batch},
                fb=(fb[0] + fb[1]).clone())
            return xs, ws, fb

        def rec_step(batch):
            if len(self.steps) >= self.n:
                return step(batch)
            self._cur = {"draws": []}
            aux = step(batch)
            cur = self._cur
            cur["bce"], cur["recon"] = aux["bce"].clone(), aux["recon"].clone()
            cur["pred"] = aux["pred"].detach().float().clone()
            tr = self.trainer
            leaves = named_leaves(tr.params)
            if not self.steps:
                st = tr.optimizer.state
                # no moment: the optimizer took no gradient for the leaf
                self.first_grad = {
                    n: ((st[t]["exp_avg"] / (1.0 - b1)).norm()
                        if "exp_avg" in st.get(t, {})
                        else torch.zeros((), device=t.device))
                    for n, t in leaves}
            self.steps.append(cur)
            if len(self.steps) == self.n:
                p0 = dict(named_leaves(self.params0))
                self.change = {n: (t.detach() - p0[n]).norm()
                               for n, t in leaves}
                self._patch.undo()
            return aux

        p = self._patch
        p.set(modules, "rand", rec_rand)
        p.set(hypersagnn, "rand", rec_rand)
        p.set(hypersagnn, "_recon_chrom", rec_recon_chrom)
        p.set(runtime, "_sample_all_negatives", rec_sample)
        p.set(self.trainer, "train_step", rec_step)
        return self

    def remove(self) -> None:
        self._patch.undo()

    def to_host(self) -> None:
        """Every kept tensor to the host (frees the card's copies)."""
        for st in self.steps:
            st["draws"] = [u.cpu() for u in st["draws"]]
            for key in ("xs", "ws"):
                st[key] = {k: v.cpu() for k, v in st[key].items()}
            st["fallback"] = int(st.pop("fb"))
            st["pred"] = st["pred"].cpu()
            st["bce"], st["recon"] = float(st["bce"]), float(st["recon"])
        self.first_grad = {n: float(v) for n, v in self.first_grad.items()}
        self.change = {n: float(v) for n, v in self.change.items()}
