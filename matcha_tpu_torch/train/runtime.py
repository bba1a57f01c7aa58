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
host synchronisation inside it except the sampler's phase-2 test.

Not ported yet: ``Trainer.fit``, eval and the per-size metrics, checkpoints
and resume, the embedding export, the regress task mode and multi-GPU
meshes.

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
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.interop import params_from_numpy, params_to_numpy
from matcha_tpu_torch.models.hypersagnn import (FrozenTables, ModelDims,
                                                build_frozen_tables,
                                                encode_node_table, forward,
                                                forward_buckets)
from matcha_tpu_torch.models.modules import split_generator
from matcha_tpu_torch.sampler.bloom import DeviceBloomFilter
from matcha_tpu_torch.sampler.negative import (ChromTable,
                                               sample_negatives_with_stats)


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


def batch_loss(params, frozen: FrozenTables, dims: ModelDims,
               table: ChromTable, blooms, settings: TrainSettings, batch,
               generator, node_table, train: bool,
               recon_chrom: Optional[int] = None):
    """Loss and aux (bce, recon, predictions, sampler fallbacks) of one
    step's dict {k: (positives (B, k), weights (B,))} of buckets."""
    if settings.task_mode == "regress":
        raise NotImplementedError("the regress task mode is not ported yet")
    fn = (_batch_loss_padded
          if settings.token_stream == "padded" and len(batch) > 1
          else _batch_loss_merged)
    return fn(params, frozen, dims, table, blooms, settings, batch,
              generator, node_table, train, recon_chrom)


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
        device, then the epoch result (one synchronisation at the end)."""
        steps = next(iter(stacked.values()))[0].shape[0]
        auxs = [self.train_step({k: (e[s], w[s])
                                 for k, (e, w) in stacked.items()})
                for s in range(steps)]
        aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
        aux = {k: v.cpu().numpy() for k, v in aux.items()}   # synchronises
        elapsed = time.perf_counter() - t0
        rows = max(int(aux["fallback_rows"].sum()), 1)
        return {"bce": float(aux["bce"].mean()),
                "recon": float(aux["recon"].mean()),
                "fallback_bloom_rate":
                    float(aux["fallback_bloom"].sum()) / rows,
                "fallback_orig_rate": float(aux["fallback_orig"].sum()) / rows,
                "elapsed": elapsed,
                "hyperedges_per_sec": aux["pred"].size / elapsed}

    def pin_base_buckets(self, batcher: BucketedBatcher,
                         budget_bytes: int = 4096 << 20) -> bool:
        """Copy the batcher's base bucket arrays to the params' device for
        indexed epochs.  -> False (nothing pinned) when they exceed
        ``budget_bytes``; ``train_epoch`` then stages the rows instead."""
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
