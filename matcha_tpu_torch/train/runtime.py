"""Training runtime and model bundle I/O.

Port of ``matcha_tpu/train/runtime.py``.  One train step is negative
sampling + the merged token-stream forward (``forward_buckets``) + weighted
BCE (x alpha) + the inter-chromosome recon loss (x beta) + AdamW, over all
per-k buckets of the step, sharing one node-table encode.  Stage 1 is
alpha = 0, beta = 1 with no Bloom filters (negatives are copies of the
positives); stage 2 is alpha = 1, beta = 0.001 against the filters.  The
indexed epoch (``pin_base_buckets`` + ``train_epoch_indexed``) keeps the
batcher's base arrays on the card and moves only the host-drawn indices per
epoch.  PyTorch runs eagerly: an epoch is a Python loop of steps, with no
host synchronisation inside it except the sampler's phase-2 test; the
epoch's losses, sampler counters and per-size metrics (computed on the
predictions' device, ``train/metrics.py``) come back in one fetch.

``Trainer.fit`` runs one stage: epochs (indexed when the buckets fit the pin
budget, else the host batcher path), the reference's mixed-size eval after
each (``eval_epoch``), checkpoints on the best validation AUPRC of the
largest k, a resume snapshot per epoch (params, AdamW moments, the
generator's state, epoch and best: a resumed run continues the interrupted
one exactly), the reload of the best checkpoint at the end and the
embedding export.  Checkpoints are pickles of numpy arrays and Python
scalars; their params are the JAX package's tree, so its
``load_checkpoint`` reads them.  The regress task mode (the reference's
pairwise-ranking variant) keeps the JAX package's per-bucket path: a padded
``forward`` per k, a softplus MSE against the quantile weights, and a per-k
eval.  Not ported yet: the overlapped fit pipeline, orbax checkpoints and
multi-GPU meshes.

Bundle I/O: ``save_model_bundle`` / ``load_model_bundle``, file for file:
``params.pkl`` (the param tree as numpy arrays), ``meta.pkl`` (dims as a
plain dict + genome metadata), ``intra_adj.npy`` and ``inter_adj.npy``.  A
bundle written by either package loads in the other.
"""

from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from matcha_tpu_torch.data.batcher import BucketedBatcher
from matcha_tpu_torch.device import to_device
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.interop import params_from_numpy, params_to_numpy
from matcha_tpu_torch.models.hypersagnn import (FrozenTables, ModelDims,
                                                build_frozen_tables,
                                                encode_node_table, forward,
                                                forward_buckets,
                                                node_embeddings)
from matcha_tpu_torch.models.modules import split_generator
from matcha_tpu_torch.sampler.bloom import DeviceBloomFilter
from matcha_tpu_torch.sampler.negative import (ChromTable, sample_negatives,
                                               sample_negatives_with_stats)
from matcha_tpu_torch.train.metrics import (device_metrics_fn,
                                            format_metrics,
                                            metrics_from_device)


class TrainSettings(NamedTuple):
    """Knobs of a training stage (the JAX package's names and defaults)."""
    alpha: float
    beta: float
    neg_num: int = 3
    min_distance: int = 0
    max_trials: int = 8       # parallel candidate rounds per negative
    extra_rounds: int = 32    # bounded re-trial of rows all rounds missed
    max_probes_k2: int = 4    # Bloom probes per negative, k = 2
    max_probes: int = 2       # Bloom probes per negative, k >= 3
    propose_impl: str = "xla"
    learning_rate: float = 1e-3
    weight_decay: float = 0.01
    task_mode: str = "class"
    hard_ratio: float = 1.0
    # "merged": per-k attention on the merged token stream; "hybrid": merged
    # stream with one padded attention for every k >= 3; "padded": one
    # uniform pad-id-0 batch through ``forward``
    token_stream: str = "hybrid"
    # ((start, end), ...) node-id range per chromosome as host constants
    # (the Trainer sets them); None = the sampler's gather path
    chrom_bounds: Optional[tuple] = None


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def make_optimizer(params, s: TrainSettings) -> torch.optim.AdamW:
    """AdamW over every leaf of the param tree with decoupled weight decay,
    as ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay)``."""
    return torch.optim.AdamW(_leaves(params), lr=s.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=s.weight_decay)


def _sample_all_negatives(table, blooms, settings: TrainSettings, batch,
                          generator):
    """Per-k negatives over a batch dict -> ({k: x = (pos; neg)},
    {k: weights}, (bloom fallbacks, orig fallbacks, rows))."""
    xs, ws, fb = {}, {}, []
    gens = split_generator(generator, len(batch))
    for gen, k in zip(gens, sorted(batch.keys())):
        pos, w = batch[k]
        neg, st = sample_negatives_with_stats(
            gen, pos, table, settings.min_distance,
            None if blooms is None else blooms[k],
            neg_num=settings.neg_num, max_trials=settings.max_trials,
            extra_rounds=settings.extra_rounds,
            max_probes=(settings.max_probes_k2 if k == 2
                        else settings.max_probes),
            hard_ratio=settings.hard_ratio,
            chrom_bounds=settings.chrom_bounds,
            propose_impl=settings.propose_impl)
        fb.append(torch.stack([st["bloom_fallback"], st["orig_fallback"],
                               st["rows"]]))
        xs[k] = torch.cat([pos.to(torch.int32), neg])
        ws[k] = w
    fb = torch.stack(fb).sum(dim=0)
    return xs, ws, (fb[0], fb[1], fb[2])


def _bucket_bce_and_preds(logits, batch, ws):
    """Weighted BCE-with-logits averaged over buckets (positives weighted
    by their quantile weight, negatives by 1) and the sigmoid predictions,
    for per-k logits of (pos; neg) rows."""
    total = 0.0
    preds = []
    for k in sorted(batch.keys()):
        n_pos = batch[k][0].shape[0]
        lg = logits[k]
        dev = lg.device
        y = torch.cat([torch.ones(n_pos, device=dev),
                       torch.zeros(lg.shape[0] - n_pos, device=dev)])[:, None]
        ww = torch.cat([ws[k].reshape(-1).float(),
                        torch.ones(lg.shape[0] - n_pos, device=dev)])[:, None]
        bce = torch.nn.functional.binary_cross_entropy_with_logits(
            lg, y, reduction="none")
        total = total + (ww * bce).mean()
        preds.append(torch.sigmoid(lg).reshape(-1))
    return total / len(batch), torch.cat(preds)


def _aux(bce, recon, preds, fb):
    return {"bce": bce, "recon": recon, "pred": preds,
            "fallback_bloom": fb[0], "fallback_orig": fb[1],
            "fallback_rows": fb[2]}


def _batch_loss_merged(params, frozen, dims, table, blooms, settings,
                       batch, generator, node_table, train: bool,
                       recon_chrom: Optional[int] = None):
    """The merged token-stream step loss (``forward_buckets``; "hybrid"
    runs it in pad-max attention mode, "merged" in per-k)."""
    g_neg, g_fwd = split_generator(generator, 2)
    xs, ws, fb = _sample_all_negatives(table, blooms, settings, batch, g_neg)
    mode = "pad-max" if settings.token_stream == "hybrid" else "per-k"
    logits, recon = forward_buckets(params, frozen, dims, xs,
                                    generator=g_fwd, train=train,
                                    return_recon=True, node_table=node_table,
                                    attention_mode=mode,
                                    recon_chrom=recon_chrom)
    bce, preds = _bucket_bce_and_preds(logits, batch, ws)
    loss = settings.alpha * bce + settings.beta * recon
    return loss, _aux(bce, recon, preds, fb)


def _batch_loss_padded(params, frozen, dims, table, blooms, settings,
                       batch, generator, node_table, train: bool,
                       recon_chrom: Optional[int] = None):
    """One uniform pad-id-0 batch through a single ``forward`` call (pads
    take part as attention keys; masked mean over the real positions)."""
    g_neg, g_fwd = split_generator(generator, 2)
    xs, ws, fb = _sample_all_negatives(table, blooms, settings, batch, g_neg)
    ks = sorted(batch.keys())
    L = max(ks)
    x_all = torch.cat([torch.nn.functional.pad(xs[k], (0, L - k))
                       for k in ks])
    logits_all, recon = forward(params, frozen, dims, x_all,
                                generator=g_fwd, train=train,
                                return_recon=True, node_table=node_table,
                                recon_chrom=recon_chrom)
    logits = dict(zip(ks, logits_all.split([xs[k].shape[0] for k in ks])))
    bce, preds = _bucket_bce_and_preds(logits, batch, ws)
    loss = settings.alpha * bce + settings.beta * recon
    return loss, _aux(bce, recon, preds, fb)


def _batch_loss_regress(params, frozen, dims, table, blooms, settings,
                        batch, generator, node_table, train: bool,
                        recon_chrom: Optional[int] = None):
    """The pairwise-ranking variant (ref forward_op_batch_regress,
    Code/main.py:60-115), one padded ``forward`` per bucket: the target is
    the quantile weight for positives and 0 for negatives, the prediction
    softplus(logit), the loss their MSE; the reported prediction is the
    sigmoid of each positive's prediction minus its first negative's.  The
    bce and recon parts are means over the buckets."""
    g_neg, g_fwd = split_generator(generator, 2)
    xs, ws, fb = _sample_all_negatives(table, blooms, settings, batch, g_neg)
    total_bce, total_recon, preds = 0.0, 0.0, []
    for gen, k in zip(split_generator(g_fwd, len(batch)), sorted(batch)):
        n_pos = batch[k][0].shape[0]
        y = torch.cat([ws[k].reshape(-1).float(),
                       torch.zeros(xs[k].shape[0] - n_pos,
                                   device=xs[k].device)])[:, None]
        logits, recon = forward(params, frozen, dims, xs[k], generator=gen,
                                train=train, return_recon=True,
                                node_table=node_table,
                                recon_chrom=recon_chrom)
        pred = torch.nn.functional.softplus(logits)
        preds.append(torch.sigmoid(pred[:n_pos, 0]
                                   - pred[n_pos:2 * n_pos, 0]))
        total_bce = total_bce + ((pred - y) ** 2).mean()
        total_recon = total_recon + recon
    bce = total_bce / len(batch)
    recon = total_recon / len(batch)
    loss = settings.alpha * bce + settings.beta * recon
    return loss, _aux(bce, recon, torch.cat(preds), fb)


def batch_loss(params, frozen: FrozenTables, dims: ModelDims,
               table: ChromTable, blooms, settings: TrainSettings, batch,
               generator, node_table, train: bool,
               recon_chrom: Optional[int] = None):
    """Loss and aux (bce, recon, predictions, sampler fallbacks) of one
    step's dict {k: (positives (B, k), weights (B,))} of buckets.  The class
    modes run the merged token stream (or one padded batch), the regress
    mode one padded forward per bucket."""
    if settings.task_mode == "regress":
        fn = _batch_loss_regress
    else:
        fn = (_batch_loss_padded
              if settings.token_stream == "padded" and len(batch) > 1
              else _batch_loss_merged)
    return fn(params, frozen, dims, table, blooms, settings, batch,
              generator, node_table, train, recon_chrom)


def _eval_mixed_loss(params, frozen, dims, table, blooms, settings, ks,
                     batch, generator, node_table):
    """One mixed-size eval batch with the reference's eval semantics: rows
    from the pooled test set, every row padded to the largest size (pads
    take part as attention keys), negatives of each row within its own size,
    weighted BCE.  batch: (x (B, L) int32 pad 0, sizes (B,), w (B,)).

    The negatives are sampled per k over the whole batch and each row keeps
    its own size's (negative row r belongs to positive row r % B).  For a k
    below L, the rows shorter than k would carry pads into the sampler,
    never find a valid candidate and keep its re-trial loop running for
    draws that are discarded; they are replaced by the batch's first row of
    size k, which changes no kept negative.  One ``forward`` scores every
    size at once."""
    x, sizes, w = batch
    b, L = x.shape
    neg_num = settings.neg_num
    g_neg, g_fwd = split_generator(generator, 2)
    sizes_neg = sizes.repeat(neg_num)
    neg = x.repeat(neg_num, 1)       # stage 1: copies of the positives
    if blooms is not None:
        for gen, k in zip(split_generator(g_neg, len(ks)), ks):
            rows = x[:, :k]
            if k < L:
                first = torch.argmax((sizes == k).to(torch.int32))
                rows = torch.where((sizes >= k)[:, None], rows, rows[first])
            neg_k = sample_negatives(
                gen, rows, table, settings.min_distance, blooms[k],
                neg_num=neg_num, max_trials=settings.max_trials,
                extra_rounds=settings.extra_rounds,
                max_probes=(settings.max_probes_k2 if k == 2
                            else settings.max_probes),
                hard_ratio=settings.hard_ratio,
                chrom_bounds=settings.chrom_bounds,
                propose_impl=settings.propose_impl)
            neg_k = torch.nn.functional.pad(neg_k, (0, L - k))
            neg = torch.where((sizes_neg == k)[:, None], neg_k, neg)
    x_all = torch.cat([x, neg])
    logits, recon = forward(params, frozen, dims, x_all, generator=g_fwd,
                            train=False, return_recon=True,
                            node_table=node_table)
    dev = logits.device
    y = torch.cat([torch.ones(b, device=dev),
                   torch.zeros(b * neg_num, device=dev)])[:, None]
    ww = torch.cat([w.reshape(-1).float(),
                    torch.ones(b * neg_num, device=dev)])[:, None]
    bce = (ww * torch.nn.functional.binary_cross_entropy_with_logits(
        logits, y, reduction="none")).mean()
    return {"bce": bce, "recon": recon,
            "pred": torch.sigmoid(logits).reshape(-1)}


def _fetch(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """Several device tensors -> host float64 arrays in one copy (one host
    synchronisation).  Counts stay exact in float64."""
    names = list(tensors)
    flat = [tensors[n].reshape(-1).to(torch.float64) for n in names]
    host = torch.cat(flat).cpu().numpy()
    out, i = {}, 0
    for n, t in zip(names, flat):
        out[n] = host[i:i + t.numel()].reshape(tuple(tensors[n].shape))
        i += t.numel()
    return out


def labels_for_batch(batch, settings: TrainSettings):
    """Host-side label and size vectors matching batch_loss's concatenated
    predictions."""
    ys, sizes = [], []
    for k in sorted(batch.keys()):
        b = batch[k][0].shape[-2]
        if settings.task_mode == "regress":
            ys.append(np.ones(b))
            sizes.append(np.full(b, k, dtype=np.int32))
        else:
            n = b * (1 + settings.neg_num)
            y = np.zeros(n)
            y[:b] = 1.0
            ys.append(y)
            sizes.append(np.full(n, k, dtype=np.int32))
    return np.concatenate(ys), np.concatenate(sizes)


class Trainer:
    """Drives training steps over bucketed batches on one device.

    The Trainer copies ``params`` (its own leaves, each a tensor that
    requires grad), pads ``frozen.inter_z`` with f_max zero columns (the
    recon target is then a contiguous slice) and hoists the chromosome
    ranges to host constants for the sampler.  ``seed`` seeds its CPU
    generator, from which every step splits its table, negative and
    forward streams."""

    def __init__(self, params: Dict, frozen: FrozenTables, dims: ModelDims,
                 chrom_table: ChromTable, settings: TrainSettings,
                 blooms: Optional[Dict[int, DeviceBloomFilter]] = None,
                 seed: int = 0):
        self.params = _tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        if frozen.features:
            f_max = max(int(f.shape[1]) for f in frozen.features)
            short = (sum(int(f.shape[1]) for f in frozen.features) + f_max
                     - int(frozen.inter_z.shape[1]))
            if short > 0:
                frozen = frozen._replace(inter_z=torch.nn.functional.pad(
                    frozen.inter_z, (0, short)))
        if settings.chrom_bounds is None:
            settings = settings._replace(chrom_bounds=tuple(
                (int(s), int(e)) for s, e in
                zip(chrom_table.chrom_start.tolist(),
                    chrom_table.chrom_end.tolist())))
        self.frozen = frozen
        self.dims = dims
        self.chrom_table = chrom_table
        self.settings = settings
        self.blooms = blooms
        self.generator = torch.Generator().manual_seed(int(seed))
        # every leaf keeps a gradient buffer, zero where a step does not
        # reach it (the decoders of the chromosomes the recon loss did not
        # draw): optax.adamw decays and steps such leaves too, and
        # torch.optim skips a leaf whose grad is None
        for t in _leaves(self.params):
            t.grad = torch.zeros_like(t)
        self.optimizer = make_optimizer(self.params, settings)
        self._pinned = None
        self._pinned_shape = None

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step on {k: (positives (B, k) int32, weights (B,))} on the
        params' device -> aux tensors (no host synchronisation)."""
        g_tab, g_loss = split_generator(self.generator, 2)
        self.optimizer.zero_grad(set_to_none=False)
        node_table = encode_node_table(self.params, self.frozen, self.dims,
                                       generator=g_tab, train=True)
        loss, aux = batch_loss(self.params, self.frozen, self.dims,
                               self.chrom_table, self.blooms, self.settings,
                               batch, g_loss, node_table, True)
        loss.backward()
        self.optimizer.step()
        return {k: v.detach() for k, v in aux.items()}

    def _run_epoch(self, stacked, t0: float):
        """Steps over stacked {k: (edges (S, B, k), weights (S, B))} on the
        device, then the epoch result: losses, sampler counters and the
        per-size metrics of the step predictions (computed where they lie),
        fetched in one synchronisation; ``elapsed`` ends there."""
        steps = next(iter(stacked.values()))[0].shape[0]
        auxs = [self.train_step({k: (e[s], w[s])
                                 for k, (e, w) in stacked.items()})
                for s in range(steps)]
        return self._epoch_result(auxs, stacked, t0)

    def _epoch_result(self, auxs, stacked, t0: Optional[float] = None):
        """Per-step aux dicts of stacked {k: (edges (S, B, k), weights (S,
        B))} -> losses, sampler counters and per-size metrics, fetched in one
        synchronisation; with ``t0`` also the elapsed time, which ends
        there, and the rate."""
        steps = len(auxs)
        aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
        y, size = labels_for_batch({k: (e[0], w[0]) for k, (e, w) in
                                    stacked.items()}, self.settings)
        mfn = device_metrics_fn(y, size)
        vals = mfn(aux["pred"])
        host = _fetch({**{k: v for k, v in aux.items() if k != "pred"},
                       **{f"metric_{g}": v for g, v in vals.items()}})
        metrics = metrics_from_device({g: host[f"metric_{g}"] for g in vals},
                                      mfn.group_sizes, steps)
        rows = max(int(host["fallback_rows"].sum()), 1)
        out = {"bce": float(host["bce"].mean()),
               "recon": float(host["recon"].mean()),
               "metrics": metrics,
               "fallback_bloom_rate":
                   float(host["fallback_bloom"].sum()) / rows,
               "fallback_orig_rate":
                   float(host["fallback_orig"].sum()) / rows}
        if t0 is not None:
            out["elapsed"] = time.perf_counter() - t0
            out["hyperedges_per_sec"] = aux["pred"].numel() / out["elapsed"]
        return out

    def pin_base_buckets(self, batcher: BucketedBatcher,
                         budget_bytes: Optional[int] = None) -> bool:
        """Copy the batcher's base bucket arrays to the params' device for
        indexed epochs.  -> False (nothing pinned) when they exceed
        ``budget_bytes`` (default MATCHA_PIN_BUDGET_MB, else 4096 MiB);
        ``train_epoch`` then stages the rows instead."""
        if budget_bytes is None:
            budget_bytes = int(os.environ.get("MATCHA_PIN_BUDGET_MB",
                                              4096)) << 20
        if batcher.base_nbytes() > budget_bytes:
            return False
        dev = _leaves(self.params)[0].device
        self._pinned = {
            int(k): (torch.as_tensor(batcher.base_edges[k], device=dev),
                     torch.as_tensor(batcher.base_weights[k], device=dev))
            for k in batcher.k_list}
        self._pinned_shape = (batcher.num_batch_per_iter, batcher.batch_size)
        return True

    def train_epoch_indexed(self, batcher: BucketedBatcher) -> Dict:
        """One epoch over the pinned base arrays: the host draws the epoch's
        indices (the same ring state as ``train_epoch``), they are copied to
        the card and the batches gathered there."""
        if self._pinned is None:
            raise RuntimeError("call pin_base_buckets first")
        t0 = time.perf_counter()
        stacked = {}
        for k, idx in batcher.next_epoch_indices().items():
            e, w = self._pinned[k]
            idx = torch.as_tensor(idx, device=e.device).long()
            stacked[k] = (e[idx], w[idx])
        return self._run_epoch(stacked, t0)

    def train_epoch(self, batcher: BucketedBatcher) -> Dict:
        """One epoch with the batches gathered on the host and copied."""
        dev = _leaves(self.params)[0].device
        t0 = time.perf_counter()
        stacked = {k: (torch.as_tensor(e, device=dev),
                       torch.as_tensor(w, device=dev))
                   for k, (e, w) in batcher.next_epoch().items()}
        return self._run_epoch(stacked, t0)

    # ------------------------------------------------------------------ eval
    def eval_epoch(self, test_buckets, batch_size: int = 96,
                   max_samples: int = 10_000, seed: int = 0,
                   indices: Optional[np.ndarray] = None,
                   return_pred: bool = False) -> Dict:
        """The reference's eval: draw ``max_samples`` rows from the pooled
        mixed-size test set (seeded by ``seed``), score them in batches of
        ``batch_size`` with each row's own-size negatives, and pool the
        predictions for the per-size metrics.  The negatives and the recon
        chromosome draw from the Trainer's generator, as a step does.

        indices: an explicit draw (positions into the pooled set, sorted by
        k), so that a test can feed two implementations the same rows.
        return_pred: also return the predictions in batch order ([bs
        positives; neg_num x bs negatives] per batch).

        The regress mode keeps the per-k eval (``_eval_epoch_perk``): its
        pairwise comparisons need same-size pairs."""
        nan = {"bce": float("nan"), "recon": float("nan"), "metrics": {}}
        test_buckets = {k: v for k, v in test_buckets.items()
                        if len(v[0]) > 0}
        if not test_buckets:
            return nan
        if self.settings.task_mode == "regress":
            return self._eval_epoch_perk(test_buckets, batch_size,
                                         max_samples, seed)
        ks = tuple(sorted(test_buckets))
        L = max(ks)
        xs, szs, ws = [], [], []
        for k, (e, w) in sorted(test_buckets.items()):
            e = np.asarray(e, np.int32)
            xs.append(np.pad(e, ((0, 0), (0, L - k))))
            szs.append(np.full(len(e), k, np.int32))
            ws.append(np.asarray(w, np.float32).reshape(-1))
        xs, szs, ws = np.concatenate(xs), np.concatenate(szs), \
            np.concatenate(ws)
        take = min(len(xs), max_samples)
        bs = min(batch_size, take)
        if bs == 0:
            return nan
        n_batches = take // bs
        if indices is None:
            indices = np.random.default_rng(seed).permutation(len(xs))
        indices = np.asarray(indices)[:n_batches * bs]
        sizes_drawn = szs[indices].reshape(n_batches, bs)
        dev = _leaves(self.params)[0].device
        x = to_device(xs[indices].reshape(n_batches, bs, L), dev)
        sz = to_device(sizes_drawn, dev)
        w = to_device(ws[indices].reshape(n_batches, bs), dev)
        with torch.no_grad():
            node_table = encode_node_table(self.params, self.frozen,
                                           self.dims, train=False)
            auxs = [_eval_mixed_loss(
                self.params, self.frozen, self.dims, self.chrom_table,
                self.blooms, self.settings, ks, (x[i], sz[i], w[i]),
                split_generator(self.generator, 1)[0], node_table)
                for i in range(n_batches)]
        pred = torch.stack([a["pred"] for a in auxs])
        neg_num = self.settings.neg_num
        y = np.tile(np.concatenate([np.ones(bs), np.zeros(bs * neg_num)]),
                    n_batches)
        size_all = np.concatenate([np.concatenate([sb, np.tile(sb, neg_num)])
                                   for sb in sizes_drawn])
        mfn = device_metrics_fn(y, size_all)
        vals = mfn(pred.reshape(1, -1))
        got = {"bce": torch.stack([a["bce"] for a in auxs]),
               "recon": torch.stack([a["recon"] for a in auxs]),
               **{f"metric_{g}": v for g, v in vals.items()}}
        if return_pred:
            got["pred"] = pred
        host = _fetch(got)
        out = {"bce": float(host["bce"].mean()),
               "recon": float(host["recon"].mean()),
               "metrics": metrics_from_device(
                   {g: host[f"metric_{g}"] for g in vals}, mfn.group_sizes,
                   1),
               "fallback_bloom_rate": 0.0, "fallback_orig_rate": 0.0}
        if return_pred:
            out["pred"] = host["pred"].astype(np.float32).reshape(-1)
        return out

    def _eval_epoch_perk(self, test_buckets, batch_size: int,
                         max_samples: int, seed: int) -> Dict:
        """The per-k eval of the regress mode: up to max_samples / (number
        of sizes) rows of each size, in per-size batches of at most
        ``batch_size`` (a small bucket shrinks its batch), as many batches
        as the scarcest size allows; each batch is one eval-mode
        ``batch_loss`` over all sizes."""
        rng = np.random.default_rng(seed)
        per_k = max(1, max_samples // max(len(test_buckets), 1))
        plan, n_batches = {}, None
        for k, (e, _) in sorted(test_buckets.items()):
            take = min(len(e), per_k)
            bs = min(batch_size, take)
            if bs == 0:
                continue
            nb = take // bs
            n_batches = nb if n_batches is None else min(n_batches, nb)
            plan[k] = bs
        if not plan:
            return {"bce": float("nan"), "recon": float("nan"),
                    "metrics": {}}
        dev = _leaves(self.params)[0].device
        stacked = {}
        for k, bs in plan.items():
            e, w = test_buckets[k]
            idx = rng.permutation(len(e))[:n_batches * bs]
            stacked[k] = (
                to_device(np.asarray(e)[idx].reshape(n_batches, bs, k), dev),
                to_device(np.asarray(w)[idx].reshape(n_batches, bs), dev))
        with torch.no_grad():
            node_table = encode_node_table(self.params, self.frozen,
                                           self.dims, train=False)
            auxs = [batch_loss(self.params, self.frozen, self.dims,
                               self.chrom_table, self.blooms, self.settings,
                               {k: (e[i], w[i])
                                for k, (e, w) in stacked.items()},
                               split_generator(self.generator, 1)[0],
                               node_table, False)[1]
                    for i in range(n_batches)]
        return self._epoch_result(auxs, stacked)

    # ----------------------------------------------------------------- stage
    def fit(self, train_buckets, test_buckets, *, epochs: int,
            batch_size: int = 96, num_batch_per_iter: int = 1000,
            checkpoint_path: Optional[str] = None, log=print, seed: int = 0,
            metrics_logger=None, stage: str = "stage",
            embeddings_path: Optional[str] = None,
            checkpoint_format: str = "pickle",
            resume_path: Optional[str] = None, resume: bool = False,
            device_epochs: str = "auto") -> List[Dict]:
        """One stage of the schedule -> the history of {"train", "valid"}
        results per epoch.

        device_epochs: "auto" pins the buckets' base arrays on the params'
          device and runs indexed epochs when they fit the pin budget, else
          the host batcher path; "on" requires the pin; "off" takes the
          host path.  Both paths draw the same batches.
          MATCHA_DEVICE_EPOCHS overrides "auto".
        checkpoint_path: a checkpoint (``save_checkpoint``) whenever the
          validation AUPRC of the largest k is at least the best so far (the
          first epoch always saves; -bce stands in for a NaN AUPRC); the
          best is reloaded into the params at the end.
        resume_path: a full snapshot every epoch; with ``resume`` the stage
          continues after the last snapshotted epoch, exactly as the
          uninterrupted run would (the batcher is fast-forwarded and every
          eval draw is seeded by ``seed + epoch``).
        embeddings_path: the node embeddings (``export_embeddings``) at the
          start of every epoch."""
        if checkpoint_format == "orbax":
            raise NotImplementedError(
                "checkpoint_format='orbax' (sharded asynchronous "
                "checkpoints) is not ported yet; it comes with multi-GPU "
                "training (ROADMAP.md, Queue 1 item 6)")
        if checkpoint_format != "pickle":
            raise ValueError(f"checkpoint_format must be 'pickle', got "
                             f"{checkpoint_format!r}")
        if device_epochs == "auto":
            device_epochs = os.environ.get("MATCHA_DEVICE_EPOCHS", "auto")
        if device_epochs not in ("auto", "on", "off"):
            raise ValueError(f"device_epochs must be 'auto', 'on' or 'off', "
                             f"got {device_epochs!r}")
        empty_ks = [k for k, v in train_buckets.items() if len(v[0]) == 0]
        if empty_ks:
            # a tiny bucket can land every row in the test split; train on
            # the rest (eval_epoch skips its empty buckets alike)
            log(f"dropping empty train buckets: k={empty_ks}")
            train_buckets = {k: v for k, v in train_buckets.items()
                             if len(v[0]) > 0}
        batcher = BucketedBatcher(train_buckets, batch_size,
                                  num_batch_per_iter, seed=seed)
        use_indexed = False
        if device_epochs != "off":
            use_indexed = self.pin_base_buckets(batcher)
            if device_epochs == "on" and not use_indexed:
                raise ValueError("device_epochs='on' but the bucket base "
                                 "arrays exceed the pin budget")
            if not use_indexed:
                log("bucket base arrays exceed the pin budget; using the "
                    "host batcher path")
        max_k = max(train_buckets)
        best = -float("inf")
        history: List[Dict] = []
        start_epoch = 0
        if resume and resume_path:
            snap = self._load_resume(resume_path)
            if snap is not None:
                if snap.get("best") is not None:
                    best = float(snap["best"])
                start_epoch = int(snap["epoch"]) + 1
                for _ in range(start_epoch):
                    batcher.skip_epoch()
                log(f"resumed from {resume_path}: continuing at epoch "
                    f"{start_epoch} (best {best:.4f})")
        for epoch in range(start_epoch, epochs):
            if embeddings_path is not None:
                self.export_embeddings(embeddings_path)
            tr = (self.train_epoch_indexed(batcher) if use_indexed
                  else self.train_epoch(batcher))
            ev = self.eval_epoch(test_buckets, batch_size=batch_size,
                                 seed=seed + epoch)
            roc, aupr, _ = format_metrics(tr["metrics"])
            fb = ""
            if tr["fallback_bloom_rate"] or tr["fallback_orig_rate"]:
                fb = (f" sampler-fallback bloom "
                      f"{tr['fallback_bloom_rate']:.2e}"
                      f" orig {tr['fallback_orig_rate']:.2e}")
            log(f"[epoch {epoch}] train bce {tr['bce']:.4f} recon "
                f"{tr['recon']:.4f} auc: {roc} aupr: {aupr} "
                f"({tr['hyperedges_per_sec']:.0f} hyperedges/s, "
                f"{tr['elapsed']:.1f}s){fb}")
            roc, aupr, _ = format_metrics(ev["metrics"])
            log(f"[epoch {epoch}] valid bce {ev['bce']:.4f} recon "
                f"{ev['recon']:.4f} auc: {roc} aupr: {aupr}")
            history.append({"train": tr, "valid": ev})
            if metrics_logger is not None:
                metrics_logger.log_epoch(stage, epoch, tr, ev)
            val_aupr = ev["metrics"].get(
                max_k, ev["metrics"].get("all", {"auprc": 0.0}))["auprc"]
            if np.isnan(val_aupr):
                val_aupr = -float(ev["bce"])
            if checkpoint_path and val_aupr >= best:
                best = val_aupr
                save_checkpoint(checkpoint_path, self.params, self.optimizer,
                                epoch)
            if resume_path:
                save_checkpoint(resume_path, self.params, self.optimizer,
                                epoch, generator=self.generator, best=best)
        if checkpoint_path and os.path.exists(checkpoint_path):
            self._restore_params(load_checkpoint(
                checkpoint_path, device=_leaves(self.params)[0].device))
        return history

    def _restore_params(self, params) -> None:
        """Copy a param tree's values into the live leaves (the optimizer
        keeps its state for them)."""
        with torch.no_grad():
            for t, v in zip(_leaves(self.params), _leaves(params)):
                t.copy_(v)

    def _load_resume(self, resume_path: str) -> Optional[Dict]:
        """Restore a resume snapshot (params, AdamW state, generator) ->
        the snapshot's dict, or None when there is none yet."""
        if not os.path.exists(resume_path):
            return None
        snap = load_checkpoint(resume_path, full=True,
                               device=_leaves(self.params)[0].device)
        if snap.get("epoch") is None:
            return None
        self._restore_params(snap["params"])
        if snap.get("opt_state") is not None:
            st = snap["opt_state"]
            sd = self.optimizer.state_dict()
            sd["state"] = {
                i: {"step": torch.tensor(float(n)),
                    "exp_avg": torch.from_numpy(np.asarray(a)),
                    "exp_avg_sq": torch.from_numpy(np.asarray(b))}
                for i, (a, b, n) in enumerate(zip(
                    st["exp_avg"], st["exp_avg_sq"], st["step"]))}
            self.optimizer.load_state_dict(sd)
        if snap.get("key") is not None:
            self.generator.set_state(torch.from_numpy(
                np.asarray(snap["key"], np.uint8)))
        return snap

    def export_embeddings(self, path: str, params=None) -> np.ndarray:
        """The node embeddings (N, dim) of ``params`` (default: the live
        ones), saved with ``np.save`` as f32."""
        p = self.params if params is None else params
        with torch.no_grad():
            emb = node_embeddings(p, self.frozen, self.dims)
        emb = emb.float().cpu().numpy()
        np.save(path, emb)
        return emb


# ------------------------------------------------------------ checkpoints
def _adamw_state(params, optimizer) -> Dict:
    """AdamW's moments and step count per leaf, in ``_leaves`` order, as
    numpy arrays and floats (zeros for a leaf not stepped yet)."""
    out = {"exp_avg": [], "exp_avg_sq": [], "step": []}
    for t in _leaves(params):
        st = optimizer.state.get(t, {})
        zero = np.zeros(tuple(t.shape), np.float32)
        out["exp_avg"].append(st["exp_avg"].detach().cpu().numpy()
                              if "exp_avg" in st else zero)
        out["exp_avg_sq"].append(st["exp_avg_sq"].detach().cpu().numpy()
                                 if "exp_avg_sq" in st else zero)
        out["step"].append(float(st["step"]) if "step" in st else 0.0)
    return out


def save_checkpoint(path: str, params, optimizer=None, epoch=None,
                    generator: Optional[torch.Generator] = None,
                    best=None) -> None:
    """A checkpoint as one pickle of numpy arrays and Python scalars:
    "params" (the JAX package's param tree, readable by its
    ``load_checkpoint``), "opt_state" (AdamW's exp_avg / exp_avg_sq / step
    per leaf in ``_leaves`` order), "epoch", "key" (the Trainer generator's
    state, for resume snapshots) and "best"."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": params_to_numpy(params),
                     "opt_state": (None if optimizer is None
                                   else _adamw_state(params, optimizer)),
                     "epoch": epoch,
                     "key": (None if generator is None
                             else generator.get_state().numpy()),
                     "best": None if best is None else float(best)}, f)


def load_checkpoint(path: str, full: bool = False, device="cuda"):
    """-> the params on ``device`` (or, with ``full``, the whole dict).
    Reads the port's checkpoints and the JAX package's written without an
    optimizer state (its optax state needs optax to unpickle).  Unpickles
    the file: load only checkpoints this project wrote."""
    with open(path, "rb") as f:
        ckpt = pickle.load(f)
    if not isinstance(ckpt, dict) or "params" not in ckpt:
        ckpt = {"params": ckpt, "opt_state": None, "epoch": None}
    ckpt["params"] = params_from_numpy(ckpt["params"], device)
    return ckpt if full else ckpt["params"]


def save_model_bundle(path: str, params, dims: ModelDims, genome,
                      intra_adj=None, inter_adj=None) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.pkl"), "wb") as f:
        pickle.dump(params_to_numpy(params), f)
    with open(os.path.join(path, "meta.pkl"), "wb") as f:
        pickle.dump({"dims": dims._asdict(),
                     "chrom_names": genome.chrom_names,
                     "chrom_sizes": genome.chrom_sizes,
                     "resolution": genome.resolution}, f)
    if intra_adj is not None:
        np.save(os.path.join(path, "intra_adj.npy"), intra_adj)
    if inter_adj is not None:
        np.save(os.path.join(path, "inter_adj.npy"), inter_adj)


def load_model_bundle(path: str, device="cuda"):
    """-> (params, dims, genome, frozen), params and frozen on ``device``.
    Unpickles the bundle: load only bundles this project wrote."""
    with open(os.path.join(path, "params.pkl"), "rb") as f:
        params = params_from_numpy(pickle.load(f), device)
    with open(os.path.join(path, "meta.pkl"), "rb") as f:
        meta = pickle.load(f)
    genome = GenomeBins(meta["chrom_names"], meta["chrom_sizes"],
                        meta["resolution"])
    dims = ModelDims(**meta["dims"])
    # the adjacency matrices are optional ("table" mode needs no features)
    ip = os.path.join(path, "intra_adj.npy")
    jp = os.path.join(path, "inter_adj.npy")
    n = genome.num_nodes
    intra = np.load(ip) if os.path.exists(ip) else np.zeros((n, n),
                                                            np.float32)
    inter = np.load(jp) if os.path.exists(jp) else np.zeros((n, n),
                                                            np.float32)
    frozen = build_frozen_tables(genome, intra, inter, device=device)
    return params, dims, genome, frozen
