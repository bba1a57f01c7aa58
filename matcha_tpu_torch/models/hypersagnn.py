"""The Hyper-SAGNN hyperedge classifier.

Port of ``matcha_tpu/models/hypersagnn.py``: the whole frozen feature table
is encoded once (per-chromosome tied autoencoders) into a node-embedding
table H of shape (N+1, dim), and a batch is scored from one gather H[x].
The reference's quirks are kept: the encoder's static output is the
pre-attention embedding, the score is the masked mean over positions of
pff_classifier((dynamic - static)^2) with a +1e-15 guard, forward returns
raw logits, and the inter-chromosome reconstruction loss decodes the node
embeddings of one random chromosome's complement, x100.

Parameters are the JAX package's param tree with tensors as leaves (see
``interop.py``).  Train mode draws its dropout masks from an explicit CPU
``torch.Generator`` (see ``models/modules.py``); the recon loss's chromosome
is drawn from it on the host, or passed in as ``recon_chrom``.  With the
fused tail on (``configure_fuse_tail`` / ``MATCHA_FUSE_TAIL``),
``forward_buckets`` runs the classifier tail through ``ops/fused_tail.py``
(K6 on a CUDA tensor).  ``MATCHA_RECON_BF16=1`` runs the recon decode with
bf16 operands and f32 accumulation.  Feature dropout is drawn per node row
of the table (``per_node``, the default) or per token occurrence
(``per_occurrence``, the reference's placement).  On the card the node
table's encode after the feature-dropout draws is K8 (``ops/node_encode.py``,
one launch a direction for every chromosome).

``forward_buckets(n_shards=ns)`` lays the merged stream out shard-major
(``parallel/stream.py``), as a mesh of ns data shards does.  Under an
active mesh (``parallel/mesh.py``, installed by the Trainer) every rank
takes the whole batch and computes its block of rows of every bucket
(``rank_rows``): the gather (``table_gather_sharded``, K3), the attention
(K1/K2), the tail (``fused_tail_sharded``, K6) and the classifier run on
those rows; the dropout masks are drawn for the whole batch and sliced, so
a mesh trains as one rank with ``n_shards = D`` does; the logits reach every
rank through one all-gather.  The encode runs on the rank's row block of
each feature table (the model axis) and an all-gather builds the whole node
table; the recon loss runs over the rank's rows of ``inter_z`` with the
global token counts (``bincount_sharded``, K4) and is summed over the
model axis.  Per-occurrence feature dropout draws one mask row per token of
the whole stream; under a model axis the ranks of a data row embed the
tokens whose feature rows they hold and a reduce-scatter hands each rank
its own (``_per_occurrence_rows``).  With tensor-parallel weights (a block
of the heads per model rank) the attention runs the rank's heads on its
data row's rows (``models/modules.py:mha_dynamic``).
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.device import resolve_device, to_device
from matcha_tpu_torch.models.modules import (encoder_layer,
                                             encoder_layer_init, feed_forward,
                                             feed_forward_init, layer_norm,
                                             layer_norm_init, linear,
                                             linear_init, mha_dynamic, pff,
                                             pff_init, rand, split_generator)
from matcha_tpu_torch.ops import node_encode
from matcha_tpu_torch.ops.fused_tail import (D as TAIL_D, fused_tail,
                                             fused_tail_sharded, pack_ln6)
from matcha_tpu_torch.ops.table_scatter import (bincount, bincount_sharded,
                                                table_gather,
                                                table_gather_sharded)
from matcha_tpu_torch.parallel.mesh import (active_data_mesh,
                                            all_gather_blocks,
                                            all_gather_rows,
                                            model_group_rows,
                                            rank_rows, rank_sizes, rank_span,
                                            reduce_scatter_blocks)
from matcha_tpu_torch.parallel.stream import (divisible, shard_concat,
                                              shard_split, stream_positions)


class ModelDims(NamedTuple):
    """Static model geometry: the same fields, names and defaults as the JAX
    package's ``ModelDims``, so ``ModelDims(**meta["dims"])`` loads a bundle
    written by either package."""
    dim: int = 64               # embed_dim == d_model == d_k == d_v
    n_head: int = 8
    diag_mask: bool = True
    feature_dropout: float = 0.2
    num_chroms: int = 0
    num_nodes: int = 0          # N (excluding pad id 0)
    compute_dtype: str = "float32"   # or "bfloat16" (f32 master params)
    use_pallas_attention: bool = False  # TPU switch; on CUDA the port takes
                                        # its attention kernel wherever the
                                        # shape fits (modules.mha_dynamic)
    attr_dim: int = 0           # 0 = num_chroms + 1 (one-hot chrom + coord)
    feature_dropout_mode: str = "per_node"

    @property
    def cdt(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


class FrozenTables(NamedTuple):
    """Non-trainable buffers on the model's device."""
    features: Tuple[torch.Tensor, ...]  # per-chrom corrcoef (n_c, n_c)
    attr_table: torch.Tensor            # (N+1, C+1) one-hot chrom + coord
    inter_z: torch.Tensor               # (N+1, N) row-z-scored inter contacts
    chrom_of_node: torch.Tensor         # (N+1,) int32
    chrom_bounds: torch.Tensor          # (C, 2) node-id [start, end)


_FUSE_TAIL: Optional[bool] = None
_RECON_BF16: Optional[bool] = None
# the float32 bytes of one intermediate of the recon loss: a rank's node rows
# are decoded in blocks of rows under it (hg38 at 10 kb on a model axis of
# 4: 75,785 rows, 8 blocks at chr1's 24,897 columns; 1 Mb and 100 kb: one
# block)
RECON_BLOCK_BYTES = 1 << 30


def _recon_decode_bf16() -> bool:
    """MATCHA_RECON_BF16=1: the recon decode product (N, d) @ (d, F) takes
    bf16 operands and accumulates in f32 instead of running in f32.  Read
    once per process, as the fused-tail gate is."""
    global _RECON_BF16
    if _RECON_BF16 is None:
        _RECON_BF16 = os.environ.get("MATCHA_RECON_BF16", "0") == "1"
    return _RECON_BF16


def _fuse_tail_enabled() -> bool:
    """MATCHA_FUSE_TAIL, read once per process, so a run never mixes the
    fused and the unfused tail (their dropouts sit in different places)."""
    global _FUSE_TAIL
    if _FUSE_TAIL is None:
        _FUSE_TAIL = os.environ.get("MATCHA_FUSE_TAIL", "0") == "1"
    return _FUSE_TAIL


def configure_fuse_tail(enabled: bool) -> None:
    """The programmatic form of MATCHA_FUSE_TAIL.  Set it before the first
    forward: flipping the gate after it has been read raises."""
    global _FUSE_TAIL
    if _FUSE_TAIL is not None and _FUSE_TAIL != bool(enabled):
        raise RuntimeError("fuse_tail gate already consulted with value "
                           f"{_FUSE_TAIL}; set it before the first forward")
    _FUSE_TAIL = bool(enabled)


# --------------------------------------------------------------------- init
def init_model(generator: torch.Generator, dims: ModelDims,
               chrom_sizes: List[int], embedding_mode: str = "corrcoef-ae",
               device="cuda", table_init: Optional[np.ndarray] = None
               ) -> Dict:
    """Build the parameter tree: the JAX package's keys and shapes, drawn
    from the same distributions with ``generator`` (a CPU generator; the
    tensors are moved to ``device`` afterwards).

    embedding_mode "corrcoef-ae": per-chromosome tied autoencoders over the
    frozen corrcoef tables; "table": a trainable (N+1, dim) table, row 0
    zero, the legacy Wrap_Embedding path (ref History_version/Code/
    main_SPRITE.py:757-765): with ``table_init`` (N, dim), e.g. the walk
    pretraining's embeddings, the table is a zero row followed by
    ``table_init`` as f32 (no draw), else N(0, 0.02^2) draws.  The
    inter-chromosome recon loss is 0 in table mode, as in the JAX
    package."""
    dev = resolve_device(device)
    d = dims.dim
    if embedding_mode == "table":
        n_total = sum(int(c) for c in chrom_sizes)
        if table_init is not None:
            table = torch.from_numpy(np.concatenate(
                [np.zeros((1, d), np.float32),
                 np.asarray(table_init, np.float32)]))
        else:
            table = torch.randn((n_total + 1, d), generator=generator) * 0.02
            table[0] = 0.0
        embed = {"table": table}
    else:
        ae, recon = [], []
        for n_c in chrom_sizes:
            ae.append({
                "w1": linear_init(generator, int(n_c), d, use_bias=False)["w"],
                "w2": linear_init(generator, d, d, use_bias=False)["w"],
            })
        for n_c in chrom_sizes:
            recon.append(linear_init(generator, d, int(n_c)))
        embed = {"ae": ae, "recon": recon}

    attr_dim = dims.attr_dim if dims.attr_dim else len(chrom_sizes) + 1
    params = {
        "embed": embed,
        "attr_nn": linear_init(generator, attr_dim, d),
        "next_w": feed_forward_init(generator, [d, d]),
        "encoder": encoder_layer_init(generator, dims.n_head, d, d, d, d),
        "ln_dynamic": layer_norm_init(d),
        "ln_static": layer_norm_init(d),
        "pff_classifier": pff_init(generator, [d, 1]),
    }
    return _tree_to(params, dev)


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to(v, device) for v in tree)
    return tree.to(device)


def build_frozen_tables(genome, intra_adj: np.ndarray, inter_adj: np.ndarray,
                        table_dtype=torch.float32,
                        device="cuda") -> FrozenTables:
    """Host-side construction of the frozen buffers (numpy), then one copy
    to ``device``:

    * features: per-chromosome row-wise corrcoef of the intra-chrom contact
      block, NaN -> 0
    * attr_table: one-hot chromosome + coordinate scaled by the first
      chromosome's bin count; row 0 zeros for padding
    * inter_z: per-row z-score over the positive entries of the inter-chrom
      matrix, NaN -> 0, with a leading zero row (indexed by node id).

    ``table_dtype`` (torch.bfloat16 halves their memory) is the dtype of
    features and inter_z, as in the JAX package; the encode casts the
    features to the compute dtype and the recon loss reads inter_z in
    f32."""
    dev = resolve_device(device)
    C = genome.num_chroms
    n = genome.num_nodes

    features = []
    for c in range(C):
        s, e = genome.chrom_range[c]
        block = intra_adj[s - 1:e - 1, s - 1:e - 1].astype(np.float64)
        with np.errstate(invalid="ignore", divide="ignore"):
            corr = np.corrcoef(block)
        corr = np.nan_to_num(corr, nan=0.0).astype(np.float32)
        features.append(torch.from_numpy(corr).to(dev, table_dtype))

    sizes = genome.bins_per_chrom
    attr = np.zeros((n + 1, C + 1), dtype=np.float32)
    for c in range(C):
        s, e = genome.chrom_range[c]
        attr[s:e, c] = 1.0
        attr[s:e, C] = np.arange(e - s, dtype=np.float32) / float(sizes[0])

    inter = np.asarray(inter_adj, dtype=np.float32).copy()
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(inter.shape[0]):
            row = inter[i]
            pos = row > 0
            if pos.any():
                sel = row[pos]
                std = sel.std()
                row[pos] = (sel - sel.mean()) / std if std > 0 else 0.0
    inter = np.nan_to_num(inter, nan=0.0)
    inter_z = np.zeros((n + 1, n), dtype=np.float32)
    inter_z[1:, :] = inter

    return FrozenTables(
        features=tuple(features),
        attr_table=torch.from_numpy(attr).to(dev),
        inter_z=torch.from_numpy(inter_z).to(dev, table_dtype),
        chrom_of_node=torch.from_numpy(
            genome.node2chrom.astype(np.int32)).to(dev),
        chrom_bounds=torch.from_numpy(
            genome.chrom_range.astype(np.int32)).to(dev),
    )


# ---------------------------------------------------------------- embedding
def _model_sharded(mesh) -> bool:
    """Whether the frozen node-axis tables are row-sharded (a model axis
    above 1)."""
    return mesh is not None and mesh.shape["model"] > 1


def encode_node_table(params: Dict, frozen: FrozenTables, dims: ModelDims,
                      *, generator: Optional[torch.Generator] = None,
                      train: bool = False) -> torch.Tensor:
    """Encode every chromosome's frozen feature table through its tied
    autoencoder -> node embedding table H (N+1, dim), row 0 zeros.
    H = tanh(X @ W1) @ W2 per chromosome; in "table" mode the trainable
    table is the node table.  In train mode with a generator, feature
    dropout (rate ``dims.feature_dropout``) is drawn once per node row per
    step; in the ``per_occurrence`` mode the table stays clean (the
    dropout is drawn on the gathered rows, ``_per_occurrence_embed``).

    On a CUDA tensor of a width K8 takes (``ops/node_encode.py``), the
    chain after the draws is K8: one launch a direction for every
    chromosome (``_encode_k8``); the draws are the same either way.

    Under a mesh with a model axis, each feature table holds this rank's
    block of its (padded) rows: the rank encodes its rows with the masks of
    the whole table's draw, and an autograd all-gather over the model axis
    builds the whole table (its backward hands each rank the gradient of
    its rows, summed over the model axis)."""
    cdt = dims.cdt
    if "table" in params["embed"]:
        table = params["embed"]["table"].clone()
        table[0] = 0.0
        return table.to(cdt)
    if dims.feature_dropout_mode == "per_occurrence":
        train = False
    mesh = active_data_mesh()
    sharded = _model_sharded(mesh)
    feats = frozen.features
    widths = [f.shape[1] for f in feats]     # true row counts = col counts
    rows = [f.shape[0] for f in feats]       # this rank's (padded) rows
    R, W = max(rows), max(widths)
    rate = dims.feature_dropout
    drop = train and generator is not None and rate > 0.0
    # the JAX package's gate (pad-independent table volume): all chromosomes
    # as one zero-padded batched chain, else a per-chromosome loop
    batched = len(feats) > 1 and len(feats) * W * W * 4 <= (64 << 20)
    draws = _feature_draws(generator, widths, batched,
                           feats[0].device) if drop else None
    if node_encode.takes(feats, dims.dim):
        local = _encode_k8(params, feats, dims, draws, batched,
                           mesh if sharded else None)
        if not sharded:
            return local
        offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).tolist()
        return _node_rows(local, rows, offsets, widths, mesh)
    zero_row = torch.zeros((1, dims.dim), dtype=cdt, device=feats[0].device)

    def global_rows(c, n, top):
        """The whole table's row of each of this rank's n rows of
        chromosome c, clipped to top - 1 (pad rows take any mask row:
        their features are zero)."""
        return np.minimum(mesh.model_index * rows[c] + np.arange(n), top - 1)

    if batched:
        x = torch.stack([torch.nn.functional.pad(
            f.to(cdt), (0, W - f.shape[1], 0, R - f.shape[0]))
            for f in feats])                                     # (C, R, W)
        if drop:
            # the mask is drawn at the pad-independent shape (C, W, W) (a
            # corrcoef table's true row count is its width) and its rows
            # are those of the rank's rows, as the JAX package draws it
            (u,) = draws
            keep = u < 1.0 - rate
            if sharded:
                keep = keep[to_device(np.arange(len(feats))[:, None],
                                      x.device),
                            to_device(np.stack([global_rows(c, R, W) for c in
                                                range(len(feats))]),
                                      x.device)]
            else:
                keep = torch.nn.functional.pad(keep, (0, 0, 0, R - W),
                                               value=True)
            x = torch.where(keep, x / (1.0 - rate),
                            torch.zeros((), dtype=cdt, device=x.device))
        w1 = torch.stack([torch.nn.functional.pad(
            p["w1"].to(cdt), (0, 0, 0, W - p["w1"].shape[0]))
            for p in params["embed"]["ae"]])                     # (C, W, d)
        w2 = torch.stack([p["w2"].to(cdt)
                          for p in params["embed"]["ae"]])       # (C, d, d)
        h = torch.bmm(torch.tanh(torch.bmm(x, w1)), w2)          # (C, R, d)
        local = h.reshape(len(feats) * R, dims.dim)
        offsets = [c * R for c in range(len(feats))]
    else:
        blocks = []
        for c, x in enumerate(feats):
            ae = params["embed"]["ae"][c]
            x = x.to(cdt)
            if drop:
                keep = next(draws) < 1.0 - rate
                if sharded:
                    keep = keep[to_device(global_rows(c, rows[c], widths[c]),
                                          x.device)]
                x = torch.where(keep, x / (1.0 - rate),
                                torch.zeros((), dtype=cdt, device=x.device))
            h = torch.tanh(x @ ae["w1"].to(cdt)) @ ae["w2"].to(cdt)
            blocks.append(h if sharded else h[:x.shape[1]])
        if not sharded:
            return torch.cat([zero_row] + blocks, dim=0)
        local = torch.cat(blocks)
        offsets = np.concatenate([[0], np.cumsum(rows)[:-1]]).tolist()
    return _node_rows(local, rows, offsets, widths, mesh if sharded else None)


def _feature_draws(generator: torch.Generator, widths, batched: bool,
                   device):
    """The feature-dropout uniforms of one encode, drawn lazily through
    this module's ``rand`` (the name the harness's recorder patches): one
    (C, W, W) draw when ``batched``, else one (n_c, n_c) draw per
    chromosome from ``split_generator``'s children, in chromosome order.
    Both the eager chain and K8 take their draws from here."""
    C, W = len(widths), max(widths)
    if batched:
        yield rand(generator, (C, W, W), device)
    else:
        for c, g in enumerate(split_generator(generator, C)):
            yield rand(g, (widths[c], widths[c]), device)


def _encode_k8(params: Dict, feats, dims: ModelDims, draws, batched: bool,
               mesh) -> torch.Tensor:
    """The encode by K8 (``ops/node_encode.py``) on the feature-dropout
    draws of ``_feature_draws`` (None: no dropout): one keep, forward and
    backward launch for every chromosome.  Chromosome c's row j on model
    rank i reads row min(i x rows_c + j, m - 1) of its (m, m) draw (m = W
    batched, else n_c), as the eager chain indexes it.  -> the node table
    (N+1, d), or under a model axis (``mesh``) the rank's rows of every
    chromosome in order."""
    ae = params["embed"]["ae"]
    rows = [int(f.shape[0]) for f in feats]
    widths = [int(f.shape[1]) for f in feats]
    C, W = len(feats), max(widths)
    first = 0 if mesh is None else mesh.model_index
    w1s = [p["w1"] for p in ae]
    w2s = [p["w2"] for p in ae]
    plan = node_encode.plan(
        feats, w1s, w2s, dims.cdt, [W] * C if batched else widths,
        [first * r for r in rows], whole=mesh is None)
    rate = dims.feature_dropout
    bits = None
    if draws is not None:
        keep = node_encode.Keep(plan, rate)
        for u in draws:
            keep.add(u)
        bits = keep.finish()
    return node_encode.node_encode(plan, feats, bits, rate, w1s, w2s)


def _node_rows(local: torch.Tensor, rows, offsets, widths,
               mesh) -> torch.Tensor:
    """The node table from the chromosomes' encoded rows ``local``
    (chromosome c's block at offsets[c]): under a model axis (``mesh``)
    gathered over it first; node id i (1-based) -> (rank m, chrom c, local
    row) of the model axis's blocks (one rank without a model axis), after
    a zero row."""
    size = local.shape[0]
    if mesh is not None:
        local = all_gather_rows(local, mesh.model_group)
    flat_idx = _node_row_index(tuple(rows), tuple(offsets), tuple(widths),
                               size, local.device)
    return torch.cat([local.new_zeros((1, local.shape[1])),
                      local[flat_idx]], dim=0)


@functools.lru_cache(maxsize=16)
def _node_row_index(rows, offsets, widths, size: int,
                    device) -> torch.Tensor:
    """``_node_rows``' gather index on ``device``, made once per layout
    (outside inference mode, so a later training step may save it for its
    backward)."""
    with torch.inference_mode(False):
        return to_device(np.concatenate(
            [(g // rows[c]) * size + offsets[c] + g % rows[c]
             for c, g in ((c, np.arange(w)) for c, w in enumerate(widths))]),
            device)


def _per_occurrence_embed(params: Dict, frozen: FrozenTables,
                          dims: ModelDims, flat: torch.Tensor,
                          generator: Optional[torch.Generator],
                          pos: Optional[torch.Tensor] = None,
                          n_draw: Optional[int] = None) -> torch.Tensor:
    """Per-token node embeddings with the feature dropout drawn per
    occurrence (the reference's placement, ref Code/Modules.py:174,176-189):
    each token's frozen feature row, dropped out with its own mask, through
    its chromosome's tied autoencoder -> (T, d) in the compute dtype; the
    row of token id 0 is exactly zero.

    The JAX package gathers each token's W1, a (T, W, d) tensor (3.7 GB in
    bf16 at 114,688 tokens and W = 249).  Here the tokens are grouped by
    chromosome, each group's (T_c, W_c) feature rows meet their own W1 in
    one product, and the rows go back in token order: the same function in
    O(T W) memory.  The group sizes cost one host synchronisation.

    The mask is one (n_draw, W_max) draw from ``generator`` (none without a
    generator or at rate 0) in stream order, as JAX's (T, W_max) Bernoulli
    is: the token at stream position p takes row p's first W_c columns.
    ``pos`` gives each token's position in that stream (default: its
    index, n_draw = T).  Under a model axis (``parallel.mesh``) each
    feature table holds this rank's block of its rows: only the tokens
    whose rows the rank holds are embedded, the others stay zero."""
    cdt = dims.cdt
    feats = frozen.features
    n_chroms = len(feats)
    flat = flat.reshape(-1).long()
    dev = flat.device
    mesh = active_data_mesh()
    widths = [int(f.shape[1]) for f in feats]
    rows = [int(f.shape[0]) for f in feats]    # this rank's (padded) rows
    first_id = np.concatenate([[1], 1 + np.cumsum(widths)[:-1]])
    chrom = frozen.chrom_of_node[flat].long().clamp(0, n_chroms - 1)
    local = flat - to_device(first_id, dev)[chrom]  # row in the whole table
    n_rows = to_device(np.asarray(rows), dev)[chrom]
    if _model_sharded(mesh):
        local = local - mesh.model_index * n_rows
    held = (flat != 0) & (local >= 0) & (local < n_rows)
    # pads and rows held elsewhere sort after every chromosome, stay zero
    group = torch.where(held, chrom, torch.full_like(chrom, n_chroms))
    order = torch.argsort(group, stable=True)
    with telemetry.sync("groups"):
        counts = torch.bincount(group, minlength=n_chroms + 1).tolist()
    rate = dims.feature_dropout
    keep = None
    if generator is not None and rate > 0.0:
        if pos is None:
            pos, n_draw = torch.arange(flat.shape[0], device=dev), flat.shape[0]
        keep = rand(generator, (int(n_draw), max(widths)), dev) < 1.0 - rate
    zero = torch.zeros((), dtype=cdt, device=dev)
    out_rows, parts = [], []
    first = 0
    for c, f in enumerate(feats):
        n_c = counts[c]
        if n_c:
            tok = order[first:first + n_c]
            x = f[local[tok]].to(cdt)                            # (T_c, W_c)
            if keep is not None:
                x = torch.where(keep[pos[tok], :widths[c]],
                                x / (1.0 - rate), zero)
            ae = params["embed"]["ae"][c]
            parts.append(torch.tanh(x @ ae["w1"].to(cdt)) @ ae["w2"].to(cdt))
            out_rows.append(tok)
        first += n_c
    out = torch.zeros((flat.shape[0], dims.dim), dtype=cdt, device=dev)
    if parts:
        out = out.index_copy(0, torch.cat(out_rows), torch.cat(parts))
    return out


class _Occurrences(NamedTuple):
    """The per-occurrence embedding of one forward: ``tokens`` the ids
    the per-token recon runs over (this process's tokens, or under a model
    axis its data row's), ``emb`` this rank's tokens' embeddings, and
    ``sizes`` the data row's ranks' token counts (None without a model
    axis)."""
    tokens: torch.Tensor
    emb: torch.Tensor
    sizes: Optional[List[int]] = None


def _per_occurrence_rows(params: Dict, frozen: FrozenTables, dims: ModelDims,
                         rank_tokens, n_draw: int,
                         generator: Optional[torch.Generator], mesh
                         ) -> _Occurrences:
    """``_per_occurrence_embed`` of this rank's tokens under a mesh.
    rank_tokens(r) -> (ids, stream positions) of rank r's tokens; the
    masks are the whole stream's (n_draw rows).  Without a model axis the
    rank embeds its own tokens.  With one, each model rank embeds the
    tokens of its data row whose feature rows it holds, and a
    reduce-scatter over the model group sums them onto each rank's own
    tokens; its backward hands every holder its tokens' cotangents, so the
    autoencoders' gradients are summed once by the world all-reduce."""
    if not _model_sharded(mesh):
        ids, pos = rank_tokens(mesh.rank)
        return _Occurrences(ids, _per_occurrence_embed(
            params, frozen, dims, ids, generator, pos, n_draw))
    m = mesh.shape["model"]
    got = [rank_tokens(mesh.data_index * m + j) for j in range(m)]
    ids = torch.cat([g[0] for g in got])
    sizes = [int(g[0].numel()) for g in got]
    part = _per_occurrence_embed(params, frozen, dims, ids, generator,
                                 torch.cat([g[1] for g in got]), n_draw)
    return _Occurrences(ids, reduce_scatter_blocks(part, sizes,
                                                   mesh.model_group), sizes)


# -------------------------------------------------------------- recon loss
def _recon_chrom(dims: ModelDims, generator: Optional[torch.Generator],
                 r: Optional[int]) -> int:
    """The recon loss's chromosome: ``r`` when given, else one draw from
    ``generator`` on the host."""
    if r is not None:
        return r
    if generator is None:
        raise ValueError("the recon loss needs a generator or r")
    return int(torch.randint(0, dims.num_chroms, (1,), generator=generator))


def recon_loss_fn(params: Dict, frozen: FrozenTables, dims: ModelDims,
                  x_flat: torch.Tensor, node_table: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  r: Optional[int] = None) -> torch.Tensor:
    """Inter-chromosomal reconstruction auxiliary loss: pick one random
    chromosome r (from ``generator`` on the host, unless given); for batch
    nodes NOT on r, decode FF_r(tanh(embed)) and MSE against the z-scored
    inter-contact row restricted to r's columns; x100.  Computed per node
    (``recon_loss_node``)."""
    if "table" in params["embed"]:
        return torch.zeros((), device=node_table.device)   # no recon
    return recon_loss_node(params, frozen, dims, x_flat, node_table,
                           _recon_chrom(dims, generator, r))


def _padded_recon_parts(params, frozen, r: int):
    """Chromosome r's decoder padded to the max feature width F, and its
    target columns.  -> (w_r (d, F), b_r (F,), cols (F,) clipped into
    inter_z, col_ok (F,), width_r)."""
    widths = [f.shape[1] for f in frozen.features]
    f_max = int(max(widths))
    w_r = params["embed"]["recon"][r]["w"]
    b_r = params["embed"]["recon"][r]["b"]
    pad = f_max - w_r.shape[1]
    dev = w_r.device
    ar = torch.arange(f_max, device=dev)
    cols = (int(sum(widths[:r])) + ar).clamp_max(frozen.inter_z.shape[1] - 1)
    return (torch.nn.functional.pad(w_r, (0, pad)),
            torch.nn.functional.pad(b_r, (0, pad)), cols,
            ar < widths[r], widths[r])


def _round(t: torch.Tensor) -> torch.Tensor:
    """A recon decode operand: rounded to bf16 under ``MATCHA_RECON_BF16``
    (bf16 operands, f32 accumulation and an unrounded f32 result, as the
    JAX package's preferred_element_type=float32: each product of two bf16
    values is exact in f32, and TF32, where it is on, leaves bf16 values
    as they are), else as it is.  The backward rounds the
    operands' gradients alike, as autograd does through a cast."""
    return t.to(torch.bfloat16).float() if _recon_decode_bf16() else t


def _rows_and_one(t: torch.Tensor) -> torch.Tensor:
    """[round(t), 1]: the decode's left operand with the bias's column."""
    return torch.cat([_round(t), torch.ones((t.shape[0], 1),
                                            device=t.device)], dim=1)


def _block_diff(inter_z, start: int, lo: int, hi: int, a1, wb):
    """target - decode of this rank's node rows [lo, hi): chromosome r's
    columns of inter_z from ``start`` in f32, less a1 @ wb (the decode and
    its bias in one product) -> (hi - lo, F) f32."""
    diff = inter_z[lo:hi, start:start + wb.shape[1]].to(torch.float32,
                                                        copy=True)
    return diff.addmm_(a1, wb, alpha=-1.0)


class _ReconBlocks(torch.autograd.Function):
    """sum_i w_n[i] * mean over chromosome r's F columns of (target_i -
    tanh(h_i) @ w - b)^2 over a rank's node rows h (R, d), in blocks of
    ``step`` rows, so that no float32 intermediate exceeds
    ``RECON_BLOCK_BYTES``: the columns are r's own (inter_z needs no pad
    columns), the bias rides in the product as a row of ones, and no pass
    over a block is spent on a mask or a scale.  Saves h, the decoder and
    the weights only; the backward decodes each block again (the telemetry
    span ``recon_backward``)."""

    @staticmethod
    def forward(ctx, h, w, b, w_n, inter_z, start: int, step: int):
        ctx.save_for_backward(h, w, b, w_n)
        ctx.inter_z, ctx.start, ctx.step = inter_z, start, step
        wb = torch.cat([_round(w), b[None, :]])                  # (d + 1, F)
        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for lo in range(0, h.shape[0], step):
            hi = min(lo + step, h.shape[0])
            diff = _block_diff(inter_z, start, lo, hi, _rows_and_one(
                torch.tanh(h[lo:hi].float())), wb)
            total += torch.einsum("ij,ij->i", diff, diff) @ w_n[lo:hi]
        return total / w.shape[1]

    @staticmethod
    def backward(ctx, g):
        h, w, b, w_n = ctx.saved_tensors
        with telemetry.span("recon_backward"):
            d = w.shape[0]
            wb = torch.cat([_round(w), b[None, :]])
            dwb = torch.zeros(wb.shape, dtype=torch.float32, device=w.device)
            dh = torch.empty(h.shape, dtype=torch.float32, device=h.device)
            for lo in range(0, h.shape[0], ctx.step):
                hi = min(lo + ctx.step, h.shape[0])
                t = torch.tanh(h[lo:hi].float())
                a1 = _rows_and_one(t)
                diff = _block_diff(ctx.inter_z, ctx.start, lo, hi, a1, wb)
                # the decode's cotangent is diff scaled per row by s: the
                # scale goes onto the (rows, d + 1) operands instead
                s = (w_n[lo:hi] * (g * (-2.0 / w.shape[1])))[:, None]
                dwb.addmm_((a1 * s).t(), diff)
                dh[lo:hi] = _round((diff @ wb[:d].t()) * s) * (1.0 - t * t)
        return (dh.to(h.dtype), _round(dwb[:d]).to(w.dtype),
                dwb[d].to(b.dtype), None, None, None, None)


def recon_loss_node(params: Dict, frozen: FrozenTables, dims: ModelDims,
                    x_flat: torch.Tensor, node_table: torch.Tensor,
                    r: int) -> torch.Tensor:
    """Per-node form of ``recon_loss_with_chrom`` (equal up to f32 summation
    order): every token of a node shares its embedding row, so the
    token-mean MSE is the node MSE weighted by the node's token count (K4
    on a CUDA tensor).  Decodes N node rows instead of T token rows, in
    blocks of rows of at most ``RECON_BLOCK_BYTES`` of float32 at
    chromosome r's width (``_ReconBlocks``, the backward decoding each
    block again; one block at 1 Mb and 100 kb).  The telemetry count
    ``recon_blocks``.

    Under a mesh x_flat is this rank's token block: the counts are summed
    over the ranks (``bincount_sharded``).  With a model axis, inter_z
    holds this rank's block of rows: the rank decodes those rows (the JAX
    package's row-local ``inter_z[:R, cols]``) against the global
    normaliser, and the partial losses are summed over the model axis by an
    autograd all-gather."""
    mesh = active_data_mesh()
    sharded = _model_sharded(mesh)
    n_z = int(frozen.inter_z.shape[0])                  # this rank's rows
    R = int(min(node_table.shape[0],
                n_z * (mesh.shape["model"] if sharded else 1),
                frozen.chrom_of_node.shape[0]))
    cnt = (bincount_sharded(x_flat.reshape(-1), R, mesh) if mesh is not None
           else bincount(x_flat.reshape(-1), R))                # (R,) f32
    node_ids = torch.arange(R, device=cnt.device)
    w_n = cnt * ((frozen.chrom_of_node[:R] != r) & (node_ids != 0))
    denom = w_n.sum()
    lo, hi = 0, R
    if sharded:
        lo = min(mesh.model_index * n_z, R)
        hi = min(lo + n_z, R)

    widths = [int(f.shape[1]) for f in frozen.features]
    step = max(1, RECON_BLOCK_BYTES // (4 * widths[r]))
    telemetry.count("recon_blocks", -(-(hi - lo) // step))
    dec = params["embed"]["recon"][r]
    total = _ReconBlocks.apply(node_table[lo:hi], dec["w"], dec["b"],
                               w_n[lo:hi], frozen.inter_z, sum(widths[:r]),
                               step)
    loss = torch.where(denom > 0, total / denom.clamp_min(1.0),
                       torch.zeros((), device=denom.device))
    if sharded:
        loss = all_gather_rows(loss.reshape(1), mesh.model_group).sum()
    return loss * 100.0


def recon_loss_with_chrom(params: Dict, frozen: FrozenTables,
                          dims: ModelDims, x_flat: torch.Tensor,
                          emb_flat: torch.Tensor, r: int) -> torch.Tensor:
    """The per-token recon loss (the oracle ``recon_loss_node`` is held
    against, and the per-occurrence mode's): token rows of x_flat not on
    chromosome r and not pads, the mean over them.

    Under a mesh x_flat and emb_flat are this rank's tokens (with a model
    axis its data row's): with a model axis inter_z holds this rank's
    block of rows and the rank sums the tokens whose target row it holds.
    The numerator and the count are summed over the world (an autograd
    all-gather) before the division: the mean over the whole batch."""
    mesh = active_data_mesh()
    x_flat = x_flat.long()
    chrom = frozen.chrom_of_node[x_flat]
    mask = (chrom != r) & (x_flat != 0)
    rows = x_flat
    if _model_sharded(mesh):
        n_z = int(frozen.inter_z.shape[0])
        rows = x_flat - mesh.model_index * n_z
        mask = mask & (rows >= 0) & (rows < n_z)
        rows = rows.clamp(0, n_z - 1)
    mask = mask.float()
    w_r, b_r, cols, col_ok, width_r = _padded_recon_parts(params, frozen, r)
    target = frozen.inter_z[:, cols][rows].float()              # (M, F)
    recon = torch.tanh(emb_flat.float()) @ w_r + b_r            # (M, F)
    sq = torch.where(col_ok[None, :], (target - recon) ** 2,
                     torch.zeros((), device=recon.device))
    per_row = sq.sum(dim=-1) / width_r
    num, denom = (per_row * mask).sum(), mask.sum()
    if mesh is not None:
        num, denom = all_gather_rows(torch.stack([num, denom])[None],
                                     mesh.world).sum(dim=0)
    loss = torch.where(denom > 0, num / denom.clamp_min(1.0),
                       torch.zeros((), device=denom.device))
    return loss * 100.0


# ------------------------------------------------------------------ forward
def _streams(generator: Optional[torch.Generator]):
    """(table, recon, encoder) generators of one forward, split as the JAX
    package splits its key."""
    _, g_tab, g_rec, g_enc = split_generator(generator, 4)
    return g_tab, g_rec, g_enc


def _per_occurrence(params, dims: ModelDims, train: bool,
                    g_tab: Optional[torch.Generator]) -> bool:
    """Whether a forward draws its feature dropout per occurrence: train
    mode with a generator, in that mode, with the autoencoder embedding."""
    return (train and g_tab is not None
            and dims.feature_dropout_mode == "per_occurrence"
            and "table" not in params["embed"])


def _recon(params, frozen, dims, x_flat, node_table, occ, g_rec, r):
    """A forward's recon loss: per node from the table, or, with the
    per-occurrence embedding (``_Occurrences``), per token from it (the
    reference's placement, ref Code/Modules.py:192-199); under a model axis
    the data row's tokens' embeddings are gathered over the model group.
    The telemetry span ``recon``."""
    with telemetry.span("recon"):
        if occ is None:
            return recon_loss_fn(params, frozen, dims, x_flat, node_table,
                                 g_rec, r)
        emb = occ.emb
        if occ.sizes is not None:
            emb = all_gather_blocks(emb, occ.sizes,
                                    active_data_mesh().model_group)
        return recon_loss_with_chrom(params, frozen, dims, occ.tokens, emb,
                                     _recon_chrom(dims, g_rec, r))


def forward(params: Dict, frozen: FrozenTables, dims: ModelDims,
            x: torch.Tensor, *, generator: Optional[torch.Generator] = None,
            train: bool = False, return_recon: bool = False,
            node_table: Optional[torch.Tensor] = None,
            return_positions: bool = False,
            recon_chrom: Optional[int] = None):
    """Score a padded hyperedge batch x (B, L) of node ids (0 = pad) -> raw
    logits (B, 1) f32; with ``return_recon`` also the recon loss, with
    ``return_positions`` also the per-position scores (B, L) before the
    masked mean.  Under a mesh the rank scores its block of the rows and
    every rank gets all of them."""
    g_tab, g_rec, g_enc = _streams(generator)
    if node_table is None:
        node_table = encode_node_table(params, frozen, dims,
                                       generator=g_tab, train=train)
    mesh = active_data_mesh()
    b_all, L = int(x.shape[0]), int(x.shape[1])
    x_all = x
    drop_rows = group_rows = None
    if mesh is not None:
        lo, hi = rank_rows(b_all, mesh)
        x = x[lo:hi]
        drop_rows = (b_all, slice(lo, hi))
        group_rows = model_group_rows([b_all], mesh)
    x = x.long()
    npm = (x != 0).to(torch.float32)[..., None]          # (B, L, 1)

    attr_proj = linear(params["attr_nn"], frozen.attr_table.to(dims.cdt))
    occ = None
    if _per_occurrence(params, dims, train, g_tab):
        if mesh is None:
            occ = _Occurrences(x.reshape(-1), _per_occurrence_embed(
                params, frozen, dims, x, g_tab))
        else:
            def rank_tokens(r):
                a, b = rank_span(b_all, mesh.size, r)
                return (x_all[a:b].reshape(-1).long(),
                        torch.arange(a * L, b * L, device=x.device))
            occ = _per_occurrence_rows(params, frozen, dims, rank_tokens,
                                       b_all * L, g_tab, mesh)
        emb = occ.emb.reshape(*x.shape, dims.dim) + attr_proj[x]
    else:
        # node + projected-attribute tables combined per node before the
        # token gather: node_table[x] + linear(attr_table[x]) == combined[x]
        emb = (node_table + attr_proj)[x]
    h = torch.tanh(feed_forward(params["next_w"], emb))

    dynamic, static = encoder_layer(
        params["encoder"], h, npm.to(h.dtype), dims.n_head, dims.dim,
        dims.dim, diag_mask=dims.diag_mask, generator=g_enc, train=train,
        drop_rows=drop_rows, group_rows=group_rows)

    dynamic = layer_norm(params["ln_dynamic"], dynamic)
    static = layer_norm(params["ln_static"], static)
    out = (dynamic - static) ** 2 if dims.diag_mask else dynamic
    per_pos = pff(params["pff_classifier"], out).to(torch.float32)
    out = ((per_pos * npm).sum(dim=-2)                   # logits in f32
           / (npm.sum(dim=-2) + 1e-15))
    if mesh is not None:
        sizes = rank_sizes(b_all, mesh)
        out = all_gather_blocks(out, sizes, mesh.world)
        if return_positions:
            per_pos = all_gather_blocks(per_pos, sizes, mesh.world)
    rest = ()
    if return_recon:
        rest += (_recon(params, frozen, dims, x.reshape(-1), node_table,
                        occ, g_rec, recon_chrom),)
    if return_positions:
        rest += (per_pos[..., 0],)
    return (out,) + rest if rest else out


def forward_buckets(params: Dict, frozen: FrozenTables, dims: ModelDims,
                    xs: Dict[int, torch.Tensor], *,
                    generator: Optional[torch.Generator] = None,
                    train: bool = False, return_recon: bool = False,
                    node_table: Optional[torch.Tensor] = None,
                    attention_mode: str = "per-k",
                    recon_chrom: Optional[int] = None, n_shards: int = 1):
    """Forward over several per-k buckets (no padding) as one merged token
    stream: every per-token stage (the gather, next_w, pff_n1, the
    LayerNorms, the classifier, recon) runs once over the concatenated
    buckets; only the attention runs per k.  The gather's gradient is K3
    (``table_gather``) on a CUDA tensor; the per-occurrence mode's
    per-token embedding replaces the gather in train mode.

    attention_mode "per-k": one attention per bucket (k = 2 closed form);
    "pad-max": k = 2 closed form, every k >= 3 bucket padded to the largest
    k with the pad token's h and run as one attention (pads take part as
    keys, the reference's training-time semantics).

    n_shards: the data-shard count of the batch axis; above 1 the
    cross-bucket concatenations and splits take the shard-major layout
    (``parallel/stream.py``), which changes where each row's dropout mask
    is drawn and nothing else (an exact inverse pair).

    With the fused tail on, ``dims.diag_mask`` and ``dims.dim`` the kernel's
    width (64), the attention output's dropout moves into the fused tail
    (K6), whose masks come from one seed drawn on the host from the tail's
    generator; the tail trains only with a generator, as the unfused tail's
    dropouts do.  At any other width the unfused chain runs.

    Under a mesh (see the module docstring) the rank computes its block of
    every bucket's rows and the logits of all rows come back through one
    all-gather; the masks are those of the whole stream's draw in the
    n_shards layout.

    -> {k: (n_k, 1) logits}, and the recon loss with ``return_recon``."""
    if attention_mode not in ("per-k", "pad-max"):
        raise ValueError(f"attention_mode must be 'per-k' or 'pad-max', "
                         f"got {attention_mode!r}")
    g_tab, g_rec, g_enc = _streams(generator)
    if node_table is None:
        node_table = encode_node_table(params, frozen, dims,
                                       generator=g_tab, train=train)
    ks = sorted(xs.keys())
    n_all = [int(xs[k].shape[0]) for k in ks]
    tok_all = [n * k for n, k in zip(n_all, ks)]
    ns = n_shards if divisible(n_all, n_shards) else 1
    mesh = active_data_mesh()
    if mesh is None:
        spans = [(0, n) for n in n_all]
        flat = shard_concat([xs[k].reshape(-1) for k in ks], ns)  # (T,)
    else:
        spans = [rank_rows(n, mesh) for n in n_all]
        flat = torch.cat([xs[k][lo:hi].reshape(-1)
                          for k, (lo, hi) in zip(ks, spans)])
    shapes = [(hi - lo, k) for k, (lo, hi) in zip(ks, spans)]
    tok_sizes = [n_k * k for (n_k, k) in shapes]
    # the shard-major layout within this process: one rank's own rows are
    # laid out plainly (its masks are taken from the whole stream's draw)
    lay = 1 if mesh is not None else ns

    # node + projected-attribute tables combined per node, then ONE (T, d)
    # gather of the combined table; with the per-occurrence embedding the
    # per-token rows replace the gather (``combined`` still gives the
    # pad-max pad rows)
    attr_proj = linear(params["attr_nn"], frozen.attr_table.to(dims.cdt))
    combined = node_table + attr_proj
    occ = None
    if _per_occurrence(params, dims, train, g_tab):
        if mesh is None:
            occ = _Occurrences(flat, _per_occurrence_embed(
                params, frozen, dims, flat, g_tab))
        else:
            def rank_tokens(r):
                sp = [rank_span(n, mesh.size, r) for n in n_all]
                return (torch.cat([xs[k][lo:hi].reshape(-1).long()
                                   for k, (lo, hi) in zip(ks, sp)]),
                        stream_positions(tok_all, ns,
                                         [(lo * k, hi * k) for k, (lo, hi)
                                          in zip(ks, sp)], device=flat.device))
            occ = _per_occurrence_rows(params, frozen, dims, rank_tokens,
                                       sum(tok_all), g_tab, mesh)
        emb = occ.emb + attr_proj[flat.long()]
    elif mesh is not None:
        emb = table_gather_sharded(combined, flat, mesh)
    else:
        emb = table_gather(combined, flat)
    h = torch.tanh(feed_forward(params["next_w"], emb))          # (T, d)

    gens = split_generator(g_enc, len(ks) + 1)
    mha = params["encoder"]["mha"]
    # the fused tail only at the kernel's width, as the JAX package's gate
    # takes the unfused chain for shapes its kernel does not take
    use_fused_tail = (_fuse_tail_enabled() and dims.diag_mask
                      and dims.dim == TAIL_D)
    attn_drop = 0.0 if use_fused_tail else 0.3
    if attention_mode == "pad-max" and len(shapes) > 1:
        dyn = _attention_pad_max(params, dims, h, shapes, gens, train,
                                 combined, attn_drop, ns,
                                 None if mesh is None else (n_all, spans,
                                                            mesh))
    else:
        dyn = shard_concat([
            mha_dynamic(mha, hk.reshape(n_k, k, -1), dims.n_head, dims.dim,
                        dims.dim, diag_mask=dims.diag_mask, generator=gen,
                        drop_rate=attn_drop, train=train,
                        drop_rows=None if mesh is None
                        else (n, slice(lo, hi)),
                        group_rows=None if mesh is None
                        else model_group_rows([n], mesh)
                        ).reshape(n_k * k, -1)
            for (n_k, k), hk, gen, n, (lo, hi) in zip(
                shapes, shard_split(h, lay, tok_sizes), gens, n_all, spans)],
            lay)
    if use_fused_tail:
        pn = params["encoder"]["pff_n1"]
        cl = params["pff_classifier"]["layers"][0]
        ft_train = train and gens[-1] is not None
        seed = (int(torch.randint(0, 2 ** 31 - 1, (1,), generator=gens[-1]))
                if ft_train else 0)
        ft_args = (dyn, h, pack_ln6(pn["ln"], params["ln_dynamic"],
                                    params["ln_static"]),
                   pn["layers"][0]["w"], pn["layers"][0]["b"],
                   pn["layers"][1]["w"], pn["layers"][1]["b"], cl["w"],
                   cl["b"], seed, 0.3, 0.4, ft_train)
        per_pos = (fused_tail_sharded(*ft_args, mesh) if mesh is not None
                   else fused_tail(*ft_args))                    # (T, 1) f32
    else:
        rows = None
        if mesh is not None:
            rows = (sum(tok_all), stream_positions(
                tok_all, ns, [(lo * k, hi * k) for k, (lo, hi)
                              in zip(ks, spans)], device=h.device))
        dyn = pff(params["encoder"]["pff_n1"], dyn, residual=True,
                  generator=gens[-1], drop_rate=0.4, train=train,
                  drop_rows=rows)
        dynamic = layer_norm(params["ln_dynamic"], dyn)
        static = layer_norm(params["ln_static"], h)
        out = (dynamic - static) ** 2 if dims.diag_mask else dynamic
        per_pos = pff(params["pff_classifier"], out).to(torch.float32)

    means = [pp.reshape(n_k, k).mean(dim=-1, keepdim=True)
             for (n_k, k), pp in zip(shapes, shard_split(per_pos[:, 0], lay,
                                                         tok_sizes))]
    if mesh is not None:
        means = _gather_bucket_rows(means, n_all, mesh)
    logits = dict(zip(ks, means))
    if return_recon:
        return logits, _recon(params, frozen, dims, flat, node_table,
                              occ, g_rec, recon_chrom)
    return logits


def _gather_bucket_rows(parts: List[torch.Tensor], n_all: List[int],
                        mesh) -> List[torch.Tensor]:
    """Every rank's block of rows of each bucket (``parts[j]``, this rank's
    ``rank_rows`` of n_all[j]) -> each bucket's rows of all ranks, in one
    autograd all-gather over the mesh."""
    per_rank = [rank_sizes(n, mesh) for n in n_all]        # [bucket][rank]
    totals = [sum(col) for col in zip(*per_rank)]           # per rank
    got = all_gather_blocks(torch.cat(parts), totals, mesh.world)
    sizes = [per_rank[j][r] for r in range(mesh.size)
             for j in range(len(n_all))]
    pieces = got.split(sizes)
    return [torch.cat([pieces[r * len(n_all) + j] for r in range(mesh.size)])
            for j in range(len(n_all))]


def _attention_pad_max(params, dims, h, shapes, gens, train, combined,
                       drop_rate=0.3, n_shards=1, rank=None):
    """pad-max attention over the merged stream (see forward_buckets):
    k = 2 closed form; k >= 3 padded to L with the pad token's h (node id 0:
    zero embedding + attribute row 0, through next_w) and run as one
    attention; the real positions go back into the stream, laid out
    shard-major for n_shards.  rank: under a mesh, (the buckets' row
    counts, this rank's spans of them, the mesh): h holds the rank's rows
    laid out plainly, and the masks are its rows of the whole batch's draw
    in the n_shards layout."""
    lay = n_shards if rank is None else 1
    mha = params["encoder"]["mha"]
    L = max(k for _, k in shapes)
    h_pad = torch.tanh(feed_forward(params["next_w"], combined[0][None, :]))
    parts = shard_split(h, lay, [n_k * k for (n_k, k) in shapes])
    dyn_parts = [None] * len(shapes)
    padded = []
    for i, ((n_k, k), hk) in enumerate(zip(shapes, parts)):
        hk = hk.reshape(n_k, k, -1)
        if k == 2:
            rows = group = None
            if rank is not None:
                rows = (rank[0][i], slice(*rank[1][i]))
                group = model_group_rows([rank[0][i]], rank[2])
            dyn_parts[i] = mha_dynamic(
                mha, hk, dims.n_head, dims.dim, dims.dim,
                diag_mask=dims.diag_mask, generator=gens[i],
                drop_rate=drop_rate, train=train,
                drop_rows=rows, group_rows=group).reshape(n_k * k, -1)
        else:
            pad = h_pad[None].expand(n_k, L - k, h.shape[-1]).to(hk.dtype)
            padded.append((i, n_k, k, torch.cat([hk, pad], dim=1)))
    if padded:
        rows = group = None
        if rank is not None:
            idx = [p[0] for p in padded]
            n_pad = [rank[0][i] for i in idx]
            rows = (sum(n_pad), stream_positions(
                n_pad, n_shards, [rank[1][i] for i in idx],
                device=h.device))
            group = model_group_rows(n_pad, rank[2])
        dynp = mha_dynamic(mha, shard_concat([p[3] for p in padded], lay),
                           dims.n_head, dims.dim, dims.dim,
                           diag_mask=dims.diag_mask,
                           generator=gens[padded[0][0]], drop_rate=drop_rate,
                           train=train, drop_rows=rows, group_rows=group)
        for (i, n_k, k, _), dk in zip(padded, shard_split(
                dynp, lay, [p[1] for p in padded])):
            dyn_parts[i] = dk[:, :k, :].reshape(n_k * k, -1)
    return shard_concat(dyn_parts, lay)


def node_embeddings(params: Dict, frozen: FrozenTables,
                    dims: ModelDims) -> torch.Tensor:
    """All-node embedding export: the node table rows 1..N -> (N, dim)."""
    return encode_node_table(params, frozen, dims)[1:]
