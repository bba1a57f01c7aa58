"""The Hyper-SAGNN hyperedge classifier, eval mode.

Port of ``matcha_tpu/models/hypersagnn.py``: the whole frozen feature table
is encoded once (per-chromosome tied autoencoders) into a node-embedding
table H of shape (N+1, dim), and a batch is scored from one gather H[x].
The reference's quirks are kept: the encoder's static output is the
pre-attention embedding, the score is the masked mean over positions of
pff_classifier((dynamic - static)^2) with a +1e-15 guard, and forward
returns raw logits.

Parameters are the JAX package's param tree with tensors as leaves (see
``interop.py``).  Training (dropout, the recon loss) comes in a later slice:
``train=True`` and ``return_recon`` raise.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from matcha_tpu_torch.device import resolve_device
from matcha_tpu_torch.models.modules import (encoder_layer,
                                             encoder_layer_init, feed_forward,
                                             feed_forward_init, layer_norm,
                                             layer_norm_init, linear,
                                             linear_init, pff, pff_init)


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
    use_pallas_attention: bool = False  # TPU switch; on CUDA the port always
                                        # takes its attention kernel
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


# --------------------------------------------------------------------- init
def init_model(generator: torch.Generator, dims: ModelDims,
               chrom_sizes: List[int], embedding_mode: str = "corrcoef-ae",
               device="cuda") -> Dict:
    """Build the parameter tree: the JAX package's keys and shapes, drawn
    from the same distributions with ``generator`` (a CPU generator; the
    tensors are moved to ``device`` afterwards).

    embedding_mode "corrcoef-ae": per-chromosome tied autoencoders over the
    frozen corrcoef tables; "table": a trainable (N+1, dim) table, row 0
    zero."""
    dev = resolve_device(device)
    d = dims.dim
    if embedding_mode == "table":
        n_total = sum(int(c) for c in chrom_sizes)
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
                        device="cuda") -> FrozenTables:
    """Host-side construction of the frozen buffers (numpy), then one copy
    to ``device``:

    * features: per-chromosome row-wise corrcoef of the intra-chrom contact
      block, NaN -> 0
    * attr_table: one-hot chromosome + coordinate scaled by the first
      chromosome's bin count; row 0 zeros for padding
    * inter_z: per-row z-score over the positive entries of the inter-chrom
      matrix, NaN -> 0, with a leading zero row (indexed by node id)."""
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
        features.append(torch.from_numpy(corr).to(dev))

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
        inter_z=torch.from_numpy(inter_z).to(dev),
        chrom_of_node=torch.from_numpy(
            genome.node2chrom.astype(np.int32)).to(dev),
        chrom_bounds=torch.from_numpy(
            genome.chrom_range.astype(np.int32)).to(dev),
    )


# ---------------------------------------------------------------- embedding
def encode_node_table(params: Dict, frozen: FrozenTables, dims: ModelDims,
                      *, train: bool = False) -> torch.Tensor:
    """Encode every chromosome's frozen feature table through its tied
    autoencoder -> node embedding table H (N+1, dim), row 0 zeros.
    H = tanh(X @ W1) @ W2 per chromosome; in "table" mode the trainable
    table is the node table."""
    if train:
        raise NotImplementedError("train-mode encode (feature dropout) comes "
                                  "with the training slice of the port")
    cdt = dims.cdt
    if "table" in params["embed"]:
        table = params["embed"]["table"].clone()
        table[0] = 0.0
        return table.to(cdt)
    feats = frozen.features
    widths = [f.shape[1] for f in feats]     # true row counts = col counts
    rows = [f.shape[0] for f in feats]
    R, W = max(rows), max(widths)
    zero_row = torch.zeros((1, dims.dim), dtype=cdt, device=feats[0].device)
    # the JAX package's gate (pad-independent table volume): all chromosomes
    # as one zero-padded batched chain, else a per-chromosome loop
    if len(feats) > 1 and len(feats) * W * W * 4 <= (64 << 20):
        x = torch.stack([torch.nn.functional.pad(
            f.to(cdt), (0, W - f.shape[1], 0, R - f.shape[0]))
            for f in feats])                                     # (C, R, W)
        w1 = torch.stack([torch.nn.functional.pad(
            p["w1"].to(cdt), (0, 0, 0, W - p["w1"].shape[0]))
            for p in params["embed"]["ae"]])                     # (C, W, d)
        w2 = torch.stack([p["w2"].to(cdt)
                          for p in params["embed"]["ae"]])       # (C, d, d)
        h = torch.bmm(torch.tanh(torch.bmm(x, w1)), w2)          # (C, R, d)
        # row gather: node id i (1-based) -> (chrom c, local row) in h
        flat_idx = torch.from_numpy(np.concatenate(
            [c * R + np.arange(w) for c, w in enumerate(widths)])).to(
                h.device)
        table = h.reshape(len(feats) * R, dims.dim)[flat_idx]
        return torch.cat([zero_row, table], dim=0)
    blocks = [zero_row]
    for c, x in enumerate(feats):
        ae = params["embed"]["ae"][c]
        x = x.to(cdt)
        h = torch.tanh(x @ ae["w1"].to(cdt)) @ ae["w2"].to(cdt)
        blocks.append(h[:x.shape[1]])
    return torch.cat(blocks, dim=0)


# ------------------------------------------------------------------ forward
def forward(params: Dict, frozen: FrozenTables, dims: ModelDims,
            x: torch.Tensor, *, train: bool = False,
            return_recon: bool = False,
            node_table: Optional[torch.Tensor] = None,
            return_positions: bool = False):
    """Score a padded hyperedge batch x (B, L) of node ids (0 = pad) -> raw
    logits (B, 1) f32; with ``return_positions`` also the per-position
    scores (B, L) before the masked mean."""
    if train or return_recon:
        raise NotImplementedError("train mode and the recon loss come with "
                                  "the training slice of the port")
    if node_table is None:
        node_table = encode_node_table(params, frozen, dims)
    x = x.long()
    npm = (x != 0).to(torch.float32)[..., None]          # (B, L, 1)

    # node + projected-attribute tables combined per node before the token
    # gather: node_table[x] + linear(attr_table[x]) == combined[x]
    combined = node_table + linear(params["attr_nn"],
                                   frozen.attr_table.to(dims.cdt))
    h = torch.tanh(feed_forward(params["next_w"], combined[x]))

    dynamic, static = encoder_layer(
        params["encoder"], h, npm.to(h.dtype), dims.n_head, dims.dim,
        dims.dim, diag_mask=dims.diag_mask)

    dynamic = layer_norm(params["ln_dynamic"], dynamic)
    static = layer_norm(params["ln_static"], static)
    out = (dynamic - static) ** 2 if dims.diag_mask else dynamic
    per_pos = pff(params["pff_classifier"], out).to(torch.float32)
    out = ((per_pos * npm).sum(dim=-2)                   # logits in f32
           / (npm.sum(dim=-2) + 1e-15))
    if return_positions:
        return out, per_pos[..., 0]
    return out


def node_embeddings(params: Dict, frozen: FrozenTables,
                    dims: ModelDims) -> torch.Tensor:
    """All-node embedding export: the node table rows 1..N -> (N, dim)."""
    return encode_node_table(params, frozen, dims)[1:]
