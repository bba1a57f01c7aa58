"""Training runtime and model bundle I/O.

Port of ``matcha_tpu/train/runtime.py``.  One train step is negative
sampling + the merged token-stream forward (``forward_buckets``) + weighted
BCE (x alpha) + the inter-chromosome recon loss (x beta) + AdamW, over all
per-k buckets of the step, sharing one node-table encode.  Stage 1 is
alpha = 0, beta = 1 with no Bloom filters (negatives are copies of the
positives); stage 2 is alpha = 1, beta = 0.001 against the filters.  The
indexed epoch (``pin_base_buckets`` + ``train_epoch_indexed``) keeps the
batcher's base arrays on the card and moves only the host-drawn indices per
epoch; the device-resident epoch (``prepare_device_epochs`` +
``train_epoch_device``, single-device) keeps the whole buckets there and
draws each epoch's permutations there too.  PyTorch runs eagerly: an
epoch is a Python loop of steps, with no host synchronisation inside it
except the sampler's phase-2 test; the epoch's losses, sampler counters
and per-size metrics (computed on the predictions' device,
``train/metrics.py``) come back in one fetch.  Each step and each epoch is
a ``telemetry`` unit with host spans around its phases and a count of its
host synchronisations; ``fit``'s metrics log carries each epoch's split.

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
eval.

``Trainer(mesh=)`` trains on a ``parallel.mesh`` of ranks, one process
each: params replicated, the frozen node-axis tables row-sharded on the
model axis (or handed in already cut to the rank's rows), every rank
computing its block of each step's rows with the masks of the whole
batch's draw (``TrainSettings.n_shards`` = the data axis), the whole loss
on every rank scaled by 1 / W and one all-reduce of the flat gradient
before AdamW.  A mesh run equals a single rank with
``n_shards`` = D up to summation order.  ``tensor_parallel=True`` shards
the attention weights on the model axis (JAX's rule): each rank keeps its
block of the heads, whose gradients are summed over the data axis only;
checkpoints, snapshots and ``whole_params`` hold whole arrays, and every
read is cut back into the blocks.  ``fit(checkpoint_format="orbax")``
checkpoints through ``train/checkpoint.py`` (``torch.distributed.checkpoint``;
not orbax's format).

Bundle I/O: ``save_model_bundle`` / ``load_model_bundle``, file for file:
``params.pkl`` (the param tree as numpy arrays), ``meta.pkl`` (dims as a
plain dict + genome metadata), ``intra_adj.npy`` and ``inter_adj.npy``.  A
bundle written by either package loads in the other.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.data.batcher import BucketedBatcher
from matcha_tpu_torch.device import to_device
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.interop import (adamw_state_from_optax, is_optax_adamw,
                                      load_pickle, params_from_numpy,
                                      params_to_numpy, tree_leaves)
from matcha_tpu_torch.models.hypersagnn import (FrozenTables, ModelDims,
                                                build_frozen_tables,
                                                encode_node_table, forward,
                                                forward_buckets,
                                                node_embeddings)
from matcha_tpu_torch.models.modules import split_generator
from matcha_tpu_torch.parallel.mesh import (all_reduce_sum,
                                            holds_rank_blocks,
                                            replicate_params, shard_frozen,
                                            tp_axes, tp_block, tp_gather,
                                            using_active_mesh)
from matcha_tpu_torch.parallel.stream import (divisible, shard_concat,
                                              shard_split)
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
    # data-shard count of the batch axis (the Trainer sets it from its
    # mesh): the buckets' concatenations take the shard-major layout
    # (parallel/stream.py); 1 = the plain layout
    n_shards: int = 1
    # ((start, end), ...) node-id range per chromosome as host constants
    # (the Trainer sets them); None = the sampler's gather path
    chrom_bounds: Optional[tuple] = None


_leaves = tree_leaves


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_unflatten(template, leaves):
    """The inverse of ``_leaves``: a tree shaped like ``template`` (its key
    order kept) whose leaves are ``leaves``, taken in ``_leaves`` order."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(template)


def make_optimizer(params, s: TrainSettings) -> torch.optim.AdamW:
    """AdamW over every leaf of the param tree with decoupled weight decay,
    as ``optax.adamw(lr, b1=0.9, b2=0.999, eps=1e-8, weight_decay)``."""
    return torch.optim.AdamW(_leaves(params), lr=s.learning_rate,
                             betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=s.weight_decay)


def _resolve_ns(settings: TrainSettings, batch) -> int:
    """The shard-major layout factor of a step: settings.n_shards when every
    bucket's row count splits evenly over it, else 1 (the plain layout)."""
    ns = settings.n_shards
    return ns if divisible([batch[k][0].shape[-2] for k in batch], ns) else 1


def _sample_all_negatives(table, blooms, settings: TrainSettings, batch,
                          generator, ns: int = 1):
    """Per-k negatives over a batch dict -> ({k: x = (pos; neg)},
    {k: weights}, (bloom fallbacks, orig fallbacks, rows)); the x rows are
    laid out shard-major for ns > 1 (read back with ``shard_split``).  The
    telemetry span ``sample``."""
    with telemetry.span("sample"):
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
            fb.append(torch.stack([st["bloom_fallback"],
                                   st["orig_fallback"], st["rows"]]))
            xs[k] = shard_concat([pos.to(torch.int32), neg], ns)
            ws[k] = w
        fb = torch.stack(fb).sum(dim=0)
        return xs, ws, (fb[0], fb[1], fb[2])


def _bucket_bce_and_preds(logits, batch, ws, ns: int = 1):
    """Weighted BCE-with-logits averaged over buckets (positives weighted
    by their quantile weight, negatives by 1) and the sigmoid predictions,
    for per-k logits of (pos; neg) rows in the ns shard-major layout (the
    predictions come back in (pos; neg) order)."""
    total = 0.0
    preds = []
    for k in sorted(batch.keys()):
        n_pos = batch[k][0].shape[0]
        lg = logits[k]
        if ns > 1:
            lg = torch.cat(shard_split(lg, ns, [n_pos, lg.shape[0] - n_pos]))
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
    ns = _resolve_ns(settings, batch)
    g_neg, g_fwd = split_generator(generator, 2)
    xs, ws, fb = _sample_all_negatives(table, blooms, settings, batch, g_neg,
                                       ns)
    mode = "pad-max" if settings.token_stream == "hybrid" else "per-k"
    with telemetry.span("forward"):
        logits, recon = forward_buckets(
            params, frozen, dims, xs, generator=g_fwd, train=train,
            return_recon=True, node_table=node_table, attention_mode=mode,
            recon_chrom=recon_chrom, n_shards=ns)
    with telemetry.span("loss"):
        bce, preds = _bucket_bce_and_preds(logits, batch, ws, ns)
        loss = settings.alpha * bce + settings.beta * recon
    return loss, _aux(bce, recon, preds, fb)


def _batch_loss_padded(params, frozen, dims, table, blooms, settings,
                       batch, generator, node_table, train: bool,
                       recon_chrom: Optional[int] = None):
    """One uniform pad-id-0 batch through a single ``forward`` call (pads
    take part as attention keys; masked mean over the real positions)."""
    ns = _resolve_ns(settings, batch)
    g_neg, g_fwd = split_generator(generator, 2)
    xs, ws, fb = _sample_all_negatives(table, blooms, settings, batch, g_neg,
                                       ns)
    ks = sorted(batch.keys())
    L = max(ks)
    with telemetry.span("forward"):
        x_all = shard_concat([torch.nn.functional.pad(xs[k], (0, L - k))
                              for k in ks], ns)
        logits_all, recon = forward(params, frozen, dims, x_all,
                                    generator=g_fwd, train=train,
                                    return_recon=True, node_table=node_table,
                                    recon_chrom=recon_chrom)
        logits = dict(zip(ks, shard_split(logits_all, ns,
                                          [xs[k].shape[0] for k in ks])))
    with telemetry.span("loss"):
        bce, preds = _bucket_bce_and_preds(logits, batch, ws, ns)
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
        with telemetry.span("forward"):
            logits, recon = forward(params, frozen, dims, xs[k],
                                    generator=gen, train=train,
                                    return_recon=True, node_table=node_table,
                                    recon_chrom=recon_chrom)
        with telemetry.span("loss"):
            y = torch.cat([ws[k].reshape(-1).float(),
                           torch.zeros(xs[k].shape[0] - n_pos,
                                       device=xs[k].device)])[:, None]
            pred = torch.nn.functional.softplus(logits)
            preds.append(torch.sigmoid(pred[:n_pos, 0]
                                       - pred[n_pos:2 * n_pos, 0]))
            total_bce = total_bce + ((pred - y) ** 2).mean()
            total_recon = total_recon + recon
    with telemetry.span("loss"):
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


class _HostFetch:
    """Several device tensors on their way to the host as float64 in one
    copy (counts stay exact).  On the card the copy goes, without waiting,
    into pinned host memory on the current stream, behind an event;
    ``result()`` waits on that event (the one host synchronisation, the
    telemetry sync ``fetch``) and splits the buffer.  On the CPU the values
    are there at once."""

    def __init__(self, tensors: Dict[str, torch.Tensor]):
        self.shapes = {n: tuple(t.shape) for n, t in tensors.items()}
        flat = torch.cat([t.reshape(-1).to(torch.float64)
                          for t in tensors.values()])
        self.event = None
        if flat.is_cuda:
            self.host = torch.empty(flat.shape, dtype=flat.dtype,
                                    pin_memory=True)
            self.host.copy_(flat, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = flat

    def result(self) -> Dict[str, np.ndarray]:
        with telemetry.sync("fetch"):
            if self.event is not None:
                self.event.synchronize()
        host = self.host.numpy()
        out, i = {}, 0
        for n, shape in self.shapes.items():
            size = int(np.prod(shape))
            out[n] = host[i:i + size].reshape(shape)
            i += size
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


def _pool_test_rows(test_buckets):
    """The reference eval's pooled test set: every non-empty bucket's rows
    padded with 0 to the largest k, sorted by k -> (ks, rows (n, L) int32,
    sizes (n,) int32, weights (n,) f32)."""
    ks = tuple(sorted(test_buckets))
    L = max(ks)
    xs, szs, ws = [], [], []
    for k, (e, w) in sorted(test_buckets.items()):
        e = np.asarray(e, np.int32)
        xs.append(np.pad(e, ((0, 0), (0, L - k))))
        szs.append(np.full(len(e), k, np.int32))
        ws.append(np.asarray(w, np.float32).reshape(-1))
    return ks, np.concatenate(xs), np.concatenate(szs), np.concatenate(ws)


class Trainer:
    """Drives training steps over bucketed batches on one device, or on a
    mesh of ranks (one process each).

    The Trainer copies ``params`` (its own leaves, each a tensor that
    requires grad), takes ``frozen.inter_z`` as it comes (with or without
    f_max zero pad columns: the recon loss reads chromosome r's own
    columns) and hoists the chromosome ranges to host constants for the
    sampler.  ``seed`` seeds its CPU
    generator, from which every step splits its table, negative and
    forward streams.

    mesh: a ``parallel.mesh.Mesh`` (every rank builds its Trainer with the
    same arguments): the params are broadcast from rank 0 (replicated),
    the frozen tables keep this rank's rows on the model axis,
    ``settings.n_shards`` becomes the data axis, and every call runs under
    the mesh.  Tables that already hold this rank's blocks of rows
    (``parallel.mesh.holds_rank_blocks``: features and inter_z cut as
    ``frozen_row_blocks`` says, f_max pad columns included or not) are
    kept as they are: no copy.  Every rank draws from the
    same generator stream, samples the whole batch's negatives and
    computes its rows; each gets the whole step's loss, logits and
    metrics.

    tensor_parallel: on a mesh with a model axis M > 1, wq, wk, wv and
    fc1's weight keep this rank's block of the heads
    (``parallel.mesh.replicate_params``): ``self.params`` then holds those
    blocks, and ``whole_params()`` (a collective: every rank calls it)
    gives the whole tree, e.g. for ``save_model_bundle`` or a next
    Trainer.  Without a mesh, or with M = 1, it is the replicated
    placement, as in the JAX package."""

    def __init__(self, params: Dict, frozen: FrozenTables, dims: ModelDims,
                 chrom_table: ChromTable, settings: TrainSettings,
                 blooms: Optional[Dict[int, DeviceBloomFilter]] = None,
                 seed: int = 0, mesh=None, tensor_parallel: bool = False):
        self.params = _tree_map(
            lambda t: t.detach().clone().requires_grad_(True), params)
        blocks = mesh is not None and holds_rank_blocks(frozen, mesh)
        if settings.chrom_bounds is None:
            settings = settings._replace(chrom_bounds=tuple(
                (int(s), int(e)) for s, e in
                zip(chrom_table.chrom_start.tolist(),
                    chrom_table.chrom_end.tolist())))
        self._tp_axes = None
        if mesh is not None:
            self.params = replicate_params(self.params, mesh,
                                           tensor_parallel, dims.n_head)
            if tensor_parallel and mesh.shape["model"] > 1:
                self._tp_axes = tp_axes(self.params)
            if not blocks:
                frozen = shard_frozen(frozen, mesh)
            settings = settings._replace(n_shards=int(mesh.shape["data"]))
        self.mesh = mesh
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
        self._dev_buckets = None
        self._dev_shape = None
        self._epochs = 0
        # the telemetry unit of the last training epoch (``_epoch_unit``)
        self.last_epoch: Optional[telemetry.Unit] = None

    def train_step(self, batch) -> Dict[str, torch.Tensor]:
        """One step on {k: (positives (B, k) int32, weights (B,))} on the
        params' device -> aux tensors (no host synchronisation on one
        device but the sampler's round tests).  Under a mesh every rank
        passes the whole batch, backs the whole loss / W through its rows,
        and the flat gradient is summed over the ranks once
        (``_sum_grads``) before AdamW.  A telemetry unit ``step`` with the
        spans ``optimizer``, ``encode``, ``sample``, ``forward``, ``loss``
        and ``backward``."""
        with telemetry.unit("step"):
            g_tab, g_loss = split_generator(self.generator, 2)
            with telemetry.span("optimizer"):
                self.optimizer.zero_grad(set_to_none=False)
            with using_active_mesh(self.mesh):
                with telemetry.span("encode"):
                    node_table = encode_node_table(self.params, self.frozen,
                                                   self.dims, generator=g_tab,
                                                   train=True)
                loss, aux = batch_loss(self.params, self.frozen, self.dims,
                                       self.chrom_table, self.blooms,
                                       self.settings, batch, g_loss,
                                       node_table, True)
                world = 1 if self.mesh is None else self.mesh.size
                with telemetry.span("backward"):
                    (loss / world if world > 1 else loss).backward()
            with telemetry.span("optimizer"):
                self._sum_grads()
                self.optimizer.step()
            return {k: v.detach() for k, v in aux.items()}

    @contextlib.contextmanager
    def _epoch_unit(self):
        """A telemetry unit ``epoch`` numbered by this Trainer's training
        epochs (0 first), with the kernel launches made inside it as its
        counts ``launches.<kernel>``; kept as ``last_epoch``."""
        before = telemetry.kernel_launches()
        with telemetry.unit("epoch", index=self._epochs) as u:
            self._epochs += 1
            yield u
            for name, n in telemetry.kernel_launches().items():
                telemetry.count(f"launches.{name}", n - before[name])
        self.last_epoch = u

    def _sum_grads(self) -> None:
        """Under a mesh with a process group: one all-reduce (SUM) of every
        replicated leaf's gradient as a flat f32 buffer over the world.
        Each rank's gradient is that of its copy of the loss / W through its
        own rows, so the sum is the whole loss's gradient, every parameter
        summed exactly once.  Under tensor parallelism the head-sharded
        leaves' gradients (each rank's data row's share) take a second flat
        all-reduce over the data axis only (``parallel/mesh.py``)."""
        if self.mesh is None or self.mesh.world is None:
            return
        leaves = _leaves(self.params)
        axes = self._tp_axes or [None] * len(leaves)
        _flat_sum([t.grad for t, a in zip(leaves, axes) if a is None],
                  self.mesh.world)
        if self.mesh.shape["data"] > 1:
            _flat_sum([t.grad for t, a in zip(leaves, axes) if a is not None],
                      self.mesh.data_group)

    def whole_params(self) -> Dict:
        """The param tree with whole leaves: ``self.params`` itself, or
        under tensor parallelism a copy whose head-sharded leaves are
        gathered over the model group (a collective: every rank calls
        it)."""
        if self._tp_axes is None:
            return self.params
        return _tree_unflatten(self.params, [
            tp_gather(t, a, self.mesh) for t, a in
            zip(_leaves(self.params), self._tp_axes)])

    def _whole_adamw_state(self) -> Dict:
        """``_adamw_state`` with whole moments (gathered as
        ``whole_params`` gathers; every rank calls it under tensor
        parallelism)."""
        axes = self._tp_axes
        return _adamw_state(self.params, self.optimizer, None if axes is None
                            else lambda i, t: tp_gather(t, axes[i],
                                                        self.mesh))

    def _block(self, i: int, v) -> torch.Tensor:
        """This rank's block of leaf i's whole value ``v``."""
        v = v if isinstance(v, torch.Tensor) else torch.as_tensor(
            np.asarray(v))
        return v if self._tp_axes is None else tp_block(
            v, self._tp_axes[i], self.mesh)

    def _run_epoch(self, stacked, t0: float):
        """Steps over stacked {k: (edges (S, B, k), weights (S, B))} on the
        device, then the epoch result: losses, sampler counters and the
        per-size metrics of the step predictions (computed where they lie),
        fetched in one synchronisation; ``elapsed`` ends there."""
        return self._finish_indexed(self._launch_epoch(stacked), t0=t0)

    def _launch_epoch(self, stacked) -> Dict:
        """Dispatch the steps over stacked {k: (edges (S, B, k), weights
        (S, B))} -> the epoch's device aux (``_launch_result``)."""
        steps = next(iter(stacked.values()))[0].shape[0]
        auxs = [self.train_step({k: (e[s], w[s])
                                 for k, (e, w) in stacked.items()})
                for s in range(steps)]
        return self._launch_result(auxs, stacked)

    def _launch_result(self, auxs, stacked) -> Dict:
        """Per-step aux dicts of stacked {k: (edges (S, B, k), weights (S,
        B))} -> the epoch's aux: the losses, sampler counters and per-size
        metric values computed on the device, their copy to the host started
        (``_HostFetch``) and not waited for."""
        aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
        y, size = labels_for_batch({k: (e[0], w[0]) for k, (e, w) in
                                    stacked.items()}, self.settings)
        mfn = device_metrics_fn(y, size)
        vals = mfn(aux["pred"])
        fetch = _HostFetch({**{k: v for k, v in aux.items() if k != "pred"},
                            **{f"metric_{g}": v for g, v in vals.items()}})
        return {"fetch": fetch, "groups": list(vals),
                "group_sizes": mfn.group_sizes, "steps": len(auxs),
                "pred_size": aux["pred"].numel()}

    def _finish_indexed(self, aux: Dict, elapsed: Optional[float] = None,
                        t0: Optional[float] = None) -> Dict:
        """The one fetch of an epoch's aux (``_launch_result``) and the
        result: losses, sampler fallback rates, per-size metrics and, with
        ``elapsed`` (or ``t0``, then the time until the fetch ends), the
        elapsed time and the rate.  Touches host arrays only."""
        host = aux["fetch"].result()
        if t0 is not None:
            elapsed = time.perf_counter() - t0
        metrics = metrics_from_device(
            {g: host[f"metric_{g}"] for g in aux["groups"]},
            aux["group_sizes"], aux["steps"])
        rows = max(int(host["fallback_rows"].sum()), 1)
        out = {"bce": float(host["bce"].mean()),
               "recon": float(host["recon"].mean()),
               "metrics": metrics,
               "fallback_bloom_rate":
                   float(host["fallback_bloom"].sum()) / rows,
               "fallback_orig_rate":
                   float(host["fallback_orig"].sum()) / rows}
        if elapsed is not None:
            out["elapsed"] = elapsed
            out["hyperedges_per_sec"] = aux["pred_size"] / elapsed
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

    def train_epoch_indexed_launch(self, batcher: BucketedBatcher) -> Dict:
        """Dispatch one epoch over the pinned base arrays -> its device aux,
        not fetched (``_finish_indexed`` fetches it).  The host draws the
        epoch's indices (the same ring state as ``train_epoch``), they are
        copied to the card and the batches gathered there."""
        if self._pinned is None:
            raise RuntimeError("call pin_base_buckets first")
        stacked = {}
        for k, idx in batcher.next_epoch_indices().items():
            e, w = self._pinned[k]
            with telemetry.sync("indices"):
                idx = torch.as_tensor(idx, device=e.device).long()
            stacked[k] = (e[idx], w[idx])
        return self._launch_epoch(stacked)

    def train_epoch_indexed(self, batcher: BucketedBatcher) -> Dict:
        """One epoch over the pinned base arrays (launch, then the one
        fetch); ``elapsed`` ends when the result is on the host."""
        with self._epoch_unit():
            t0 = time.perf_counter()
            return self._finish_indexed(
                self.train_epoch_indexed_launch(batcher), t0=t0)

    def prepare_device_epochs(self, train_buckets, batch_size: int,
                              num_batch_per_iter: int) -> None:
        """Copy the whole training buckets to the params' device for
        device-resident epochs (``train_epoch_device``): each epoch then
        draws its permutations on the device, with no host draw or copy of
        rows or indices.  A bucket smaller than an epoch's rows is doubled
        until it covers them (the reference duplicates small buckets, ref
        Code/Modules.py:638-641).  Single-device only, as in the JAX
        package; raises on an empty bucket and under a mesh."""
        if self.mesh is not None:
            raise RuntimeError("device-resident epochs are single-device; "
                               "use train_epoch_indexed on a mesh")
        need = num_batch_per_iter * batch_size
        dev = _leaves(self.params)[0].device
        pinned = {}
        for k, (e, w) in sorted(train_buckets.items()):
            e = np.asarray(e, np.int32)
            w = np.asarray(w, np.float32)
            if len(e) == 0:
                raise ValueError(f"empty bucket for k={k}")
            while len(e) < need:
                e = np.concatenate([e, e])
                w = np.concatenate([w, w])
            pinned[int(k)] = (torch.as_tensor(e, device=dev),
                              torch.as_tensor(w, device=dev))
        self._dev_buckets = pinned
        self._dev_shape = (int(num_batch_per_iter), int(batch_size))

    def train_epoch_device_launch(self) -> Dict:
        """Dispatch one device-resident epoch -> its device aux, not
        fetched (``_finish_indexed`` fetches it).  For each k in sorted
        order one split of the Trainer's generator (a seed for a generator
        on the buckets' device, as ``jax.random.split`` gives a key per k:
        a CUDA permutation takes no CPU generator) draws a permutation of
        the bucket there, cut to (steps, batch); one gather per bucket;
        then the steps of ``_launch_epoch``."""
        if self._dev_buckets is None:
            raise RuntimeError("call prepare_device_epochs first")
        steps, batch = self._dev_shape
        stacked = {}
        for k, (e, w) in sorted(self._dev_buckets.items()):
            seed = int(torch.randint(0, 2 ** 62, (1,),
                                     generator=self.generator))
            gen = torch.Generator(device=e.device).manual_seed(seed)
            idx = torch.randperm(e.shape[0], generator=gen,
                                 device=e.device)[:steps * batch].view(
                                     steps, batch)
            stacked[k] = (e[idx], w[idx])
        return self._launch_epoch(stacked)

    def train_epoch_device(self) -> Dict:
        """One device-resident epoch (launch, then the one fetch); the
        result has ``train_epoch_indexed``'s keys."""
        with self._epoch_unit():
            t0 = time.perf_counter()
            return self._finish_indexed(self.train_epoch_device_launch(),
                                        t0=t0)

    def train_epoch(self, batcher: BucketedBatcher) -> Dict:
        """One epoch with the batches gathered on the host and copied."""
        dev = _leaves(self.params)[0].device
        with self._epoch_unit():
            t0 = time.perf_counter()
            stacked = {}
            for k, (e, w) in batcher.next_epoch().items():
                with telemetry.sync("rows"):
                    stacked[k] = (torch.as_tensor(e, device=dev),
                                  torch.as_tensor(w, device=dev))
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
        test_buckets = {k: v for k, v in test_buckets.items()
                        if len(v[0]) > 0}
        if not test_buckets:
            return self._finish_eval(None)
        if self.settings.task_mode == "regress":
            return self._eval_epoch_perk(test_buckets, batch_size,
                                         max_samples, seed)
        ks, xs, szs, ws = _pool_test_rows(test_buckets)
        take = min(len(xs), max_samples)
        bs = self._eval_batch(min(batch_size, take))
        if bs == 0:
            return self._finish_eval(None)
        n_batches = take // bs
        if indices is None:
            indices = np.random.default_rng(seed).permutation(len(xs))
        indices = np.asarray(indices)[:n_batches * bs]
        sizes_drawn = szs[indices].reshape(n_batches, bs)
        dev = _leaves(self.params)[0].device
        x = to_device(xs[indices].reshape(n_batches, bs, -1), dev)
        sz = to_device(sizes_drawn, dev)
        w = to_device(ws[indices].reshape(n_batches, bs), dev)
        return self._finish_eval(self._launch_eval(ks, x, sz, w, sizes_drawn,
                                                   return_pred))

    def _launch_eval(self, ks, x, sz, w, sizes_drawn: np.ndarray,
                     return_pred: bool = False) -> Dict:
        """Dispatch the mixed-size eval batches x (n_b, bs, L), sizes (n_b,
        bs), weights (n_b, bs) on the params' device -> a handle for
        ``_finish_eval``: the losses and per-size metric values computed on
        the device, their copy to the host started and not waited for.  The
        negatives and the recon chromosome draw from the Trainer's generator
        here, so it has advanced past this eval when the call returns."""
        n_batches, bs = sizes_drawn.shape
        with torch.no_grad(), using_active_mesh(self.mesh):
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
        return {"fetch": _HostFetch(got), "groups": list(vals),
                "group_sizes": mfn.group_sizes}

    def _eval_batch(self, bs: int) -> int:
        """An eval batch size cut to a multiple of the mesh's data axis, as
        the JAX package cuts it (0 when smaller than the data axis)."""
        nd = 1 if self.mesh is None else int(self.mesh.shape["data"])
        return (bs // nd) * nd

    def _finish_eval(self, handle: Optional[Dict]) -> Dict:
        """The one fetch of an eval dispatch (``_launch_eval``) and its
        result; None (an empty or too small test set) gives the NaN result.
        Touches host arrays only."""
        if handle is None:
            return {"bce": float("nan"), "recon": float("nan"),
                    "metrics": {}}
        host = handle["fetch"].result()
        out = {"bce": float(host["bce"].mean()),
               "recon": float(host["recon"].mean()),
               "metrics": metrics_from_device(
                   {g: host[f"metric_{g}"] for g in handle["groups"]},
                   handle["group_sizes"], 1),
               "fallback_bloom_rate": 0.0, "fallback_orig_rate": 0.0}
        if "pred" in host:
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
            bs = self._eval_batch(min(batch_size, take))
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
        with torch.no_grad(), using_active_mesh(self.mesh):
            node_table = encode_node_table(self.params, self.frozen,
                                           self.dims, train=False)
            auxs = [batch_loss(self.params, self.frozen, self.dims,
                               self.chrom_table, self.blooms, self.settings,
                               {k: (e[i], w[i])
                                for k, (e, w) in stacked.items()},
                               split_generator(self.generator, 1)[0],
                               node_table, False)[1]
                    for i in range(n_batches)]
        return self._finish_indexed(self._launch_result(auxs, stacked))

    # ----------------------------------------------------------------- stage
    def fit(self, train_buckets, test_buckets, *, epochs: int,
            batch_size: int = 96, num_batch_per_iter: int = 1000,
            checkpoint_path: Optional[str] = None, log=print, seed: int = 0,
            metrics_logger=None, stage: str = "stage",
            profile_dir: Optional[str] = None,
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
        embeddings_path: the node embeddings (``export_embeddings``) of the
          params at the start of every epoch.
        profile_dir: a ``torch.profiler`` trace of epoch 1's training and
          eval (the first epoch after the warm-up epoch 0) under this
          directory (``telemetry.profile_trace``).
        checkpoint_format: "pickle" (one file, ``save_checkpoint``) or
          "orbax": ``checkpoint_path`` and ``resume_path`` are directories
          of ``train/checkpoint.OrbaxCheckpointer`` step checkpoints
          (``torch.distributed.checkpoint``, written in the background; the
          JAX package's argument, not orbax's format).

        Under a mesh every rank runs ``fit`` with the same arguments: only
        rank 0 logs and writes the pickles, the metrics log and the
        embeddings (every rank takes part in an "orbax" save); every rank
        reads the best checkpoint back at the end."""
        if checkpoint_format not in ("pickle", "orbax"):
            raise ValueError(f"checkpoint_format must be 'pickle' or "
                             f"'orbax', got {checkpoint_format!r}")
        rank0 = self.mesh is None or self.mesh.rank == 0
        if not rank0:
            log, metrics_logger = (lambda *a, **k: None), None
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
        ckpt_mgr = resume_mgr = None
        if checkpoint_format == "orbax":
            from matcha_tpu_torch.train.checkpoint import OrbaxCheckpointer
            if checkpoint_path:
                ckpt_mgr = OrbaxCheckpointer(checkpoint_path)
            if resume_path:
                resume_mgr = OrbaxCheckpointer(resume_path)
        if resume and resume_path:
            snap = self._load_resume(resume_path, resume_mgr)
            if snap is not None:
                if snap.get("best") is not None:
                    best = float(snap["best"])
                start_epoch = int(snap["epoch"]) + 1
                for _ in range(start_epoch):
                    batcher.skip_epoch()
                log(f"resumed from {resume_path}: continuing at epoch "
                    f"{start_epoch} (best {best:.4f})")

        def save_live(path, epoch, best_):
            """Write the epoch's state: a checkpoint (``best_`` None) or a
            resume snapshot with the generator and the best so far."""
            key = (None if best_ is None
                   else self.generator.get_state().numpy())
            if checkpoint_format == "orbax":
                mgr = ckpt_mgr if best_ is None else resume_mgr
                mgr.save(epoch, self.whole_params(),
                         self._whole_adamw_state(), epoch, key=key,
                         best=best_)
            elif rank0 or self._tp_axes is not None:
                # under tensor parallelism every rank gathers the blocks
                params, opt = self.whole_params(), self._whole_adamw_state()
                if rank0:
                    _write_checkpoint(path, params_to_numpy(params), opt,
                                      epoch, key, best_)

        try:
            for epoch in range(start_epoch, epochs):
                if embeddings_path is not None:
                    self.export_embeddings(embeddings_path)
                with telemetry.profile_trace(profile_dir if epoch == 1
                                             else None):
                    tr = (self.train_epoch_indexed(batcher) if use_indexed
                          else self.train_epoch(batcher))
                    split = telemetry.epoch_split(self.last_epoch)
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
                    metrics_logger.log_epoch(stage, epoch, tr, ev, host=split)
                val_aupr = ev["metrics"].get(
                    max_k, ev["metrics"].get("all", {"auprc": 0.0}))["auprc"]
                if np.isnan(val_aupr):
                    val_aupr = -float(ev["bce"])
                if checkpoint_path and val_aupr >= best:
                    best = val_aupr
                    save_live(checkpoint_path, epoch, None)
                if resume_path:
                    save_live(resume_path, epoch, best)
        finally:
            for mgr in (resume_mgr, ckpt_mgr):
                if mgr is not None:
                    mgr.close()
        if self.mesh is not None and self.mesh.world is not None:
            torch.distributed.barrier()   # rank 0's writes are done
        if ckpt_mgr is not None:
            if ckpt_mgr.latest_step() is not None:
                self._restore_params(ckpt_mgr.restore(
                    like_params=self.whole_params())[0])
        elif checkpoint_path and os.path.exists(checkpoint_path):
            self._restore_params(load_checkpoint(
                checkpoint_path, device=_leaves(self.params)[0].device))
        return history

    def _restore_params(self, params) -> None:
        """Copy a whole param tree's values into the live leaves (their
        blocks under tensor parallelism; the optimizer keeps its state for
        them)."""
        with torch.no_grad():
            for i, (t, v) in enumerate(zip(_leaves(self.params),
                                           _leaves(params))):
                t.copy_(self._block(i, v))

    def _load_resume(self, resume_path: str,
                     manager=None) -> Optional[Dict]:
        """Restore a resume snapshot (params, AdamW state, generator) from
        the pickle at ``resume_path`` or from ``manager``'s latest step (an
        ``OrbaxCheckpointer``) -> the snapshot's dict, or None when there is
        none yet."""
        if manager is not None:
            if manager.latest_step() is None:
                return None
            params, opt, epoch = manager.restore(
                like_params=self.whole_params(),
                like_opt_state=self._whole_adamw_state())
            snap = {"params": params, "opt_state": opt, "epoch": epoch,
                    "key": manager.last_meta.get("key"),
                    "best": manager.last_meta.get("best")}
        elif os.path.exists(resume_path):
            snap = load_checkpoint(resume_path, full=True,
                                   device=_leaves(self.params)[0].device)
        else:
            return None
        if snap.get("epoch") is None:
            return None
        self._restore_params(snap["params"])
        if snap.get("opt_state") is not None:
            st = snap["opt_state"]
            sd = self.optimizer.state_dict()
            sd["state"] = {
                i: {"step": torch.tensor(float(n)),
                    "exp_avg": self._block(i, a),
                    "exp_avg_sq": self._block(i, b)}
                for i, (a, b, n) in enumerate(zip(
                    st["exp_avg"], st["exp_avg_sq"], st["step"]))}
            self.optimizer.load_state_dict(sd)
        if snap.get("key") is not None:
            self.generator.set_state(torch.from_numpy(
                np.asarray(snap["key"], np.uint8)))
        return snap

    def export_embeddings(self, path: str, params=None) -> np.ndarray:
        """The node embeddings (N, dim) of ``params`` (default: the live
        ones), saved with ``np.save`` as f32 (by rank 0 under a mesh, where
        every rank calls it)."""
        p = self.params if params is None else params
        with torch.no_grad(), using_active_mesh(self.mesh):
            emb = node_embeddings(p, self.frozen, self.dims)
        emb = emb.float().cpu().numpy()
        if self.mesh is None or self.mesh.rank == 0:
            np.save(path, emb)
        return emb


# ------------------------------------------------------------ checkpoints
def _adamw_state(params, optimizer, whole=None) -> Dict:
    """AdamW's moments and step count per leaf, in ``_leaves`` order, as
    numpy arrays and floats (zeros for a leaf not stepped yet).  whole(i,
    moment) -> leaf i's whole moment, where the leaves are blocks."""
    out = {"exp_avg": [], "exp_avg_sq": [], "step": []}
    for i, t in enumerate(_leaves(params)):
        st = optimizer.state.get(t, {})
        for name in ("exp_avg", "exp_avg_sq"):
            m = st[name].detach() if name in st else torch.zeros_like(
                t, dtype=torch.float32)
            if whole is not None:
                m = whole(i, m)
            out[name].append(m.cpu().numpy())
        out["step"].append(float(st["step"]) if "step" in st else 0.0)
    return out


def _flat_sum(grads: List[torch.Tensor], group) -> None:
    """Sum the gradients over ``group`` as one flat f32 buffer, in place."""
    if not grads:
        return
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce_sum(flat, group)
    for g, v in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(v.view(g.shape))


def save_checkpoint(path: str, params, optimizer=None, epoch=None,
                    generator: Optional[torch.Generator] = None,
                    best=None) -> None:
    """A checkpoint as one pickle of numpy arrays and Python scalars:
    "params" (the JAX package's param tree, readable by its
    ``load_checkpoint``), "opt_state" (AdamW's exp_avg / exp_avg_sq / step
    per leaf in ``_leaves`` order), "epoch", "key" (the Trainer generator's
    state, for resume snapshots) and "best"."""
    _write_checkpoint(path, params_to_numpy(params),
                      None if optimizer is None
                      else _adamw_state(params, optimizer), epoch,
                      None if generator is None
                      else generator.get_state().numpy(), best)


def _write_checkpoint(path: str, params_np, opt_np, epoch, key, best) -> None:
    """``save_checkpoint``'s file, from host values: the numpy param tree,
    the AdamW state dict, the generator state as uint8."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump({"params": params_np, "opt_state": opt_np,
                     "epoch": epoch, "key": key,
                     "best": None if best is None else float(best)}, f)


def load_checkpoint(path: str, full: bool = False, device="cuda"):
    """-> the params on ``device`` (or, with ``full``, the whole dict).
    Reads the port's checkpoints and the JAX package's, with or without
    its optax AdamW state, and imports neither optax nor JAX: the file is
    read by ``interop.load_pickle``, which takes numpy arrays, Python
    values and optax's AdamW states and refuses every other class.  A JAX
    file's optax state becomes the port's (``adamw_state_from_optax``) and
    its JAX PRNG key is dropped: a Trainer resumed from a JAX snapshot
    keeps its own generator, so it continues with the params and AdamW
    moments, not with JAX's random stream."""
    with open(path, "rb") as f:
        ckpt = load_pickle(f)
    if not isinstance(ckpt, dict) or "params" not in ckpt:
        ckpt = {"params": ckpt, "opt_state": None, "epoch": None}
    ckpt["params"] = params_from_numpy(ckpt["params"], device)
    if is_optax_adamw(ckpt.get("opt_state")):
        ckpt["opt_state"] = adamw_state_from_optax(*ckpt["opt_state"][0])
    # a torch generator's state is uint8; a JAX key (uint32) seeds nothing
    key = ckpt.get("key")
    if key is not None and np.asarray(key).dtype != np.uint8:
        ckpt["key"] = None
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
