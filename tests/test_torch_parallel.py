"""The port's multi-process training (``matcha_tpu_torch/parallel``) against
the JAX package's mesh, on the CPU.

Ranks are processes joined on gloo (``parallel.distributed.spawn``), one
world per mesh shape (2x1, 1x2, 2x2), all started at once by a module
fixture; the problem is tests/test_multichip.py's (3 chromosomes, 67 nodes,
dim 16, 4 heads, 256 edges per k).  The chain of equivalences:
  * the shard-major layout (``parallel/stream.py``) is JAX's bit for bit;
  * ``forward_buckets(n_shards=ns)`` equals JAX's (1e-5) and permutes the
    rows of its own ns = 1 stream;
  * a deterministic step of W ranks (dropout off, JAX-sampled negatives and
    the recon chromosome injected), its gradients summed over the ranks,
    equals JAX's value_and_grad under ``make_mesh(D, M)`` at
    tests/test_torch_train_step.py's tolerance (rtol 1e-4, atol 1e-5);
  * an epoch of W ranks equals one rank with ``n_shards = D`` at
    tests/test_multichip.py's tolerances (bce 1e-4, recon 2e-3, params
    rtol 5e-3 / atol 5e-4).
The same worlds hold tensor parallelism (``Trainer(tensor_parallel=True)``:
the step against JAX's mesh with ``param_sharding(..., tensor_parallel=
True)``, the epoch against one rank, checkpoints whole and resumed) and
per-occurrence feature dropout on the meshes (the step at rate 0 with the
other dropouts the identity against JAX's mesh step, the epoch against one
rank).  JAX is imported inside the tests, so the ranks (which import this
module) never load it.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from matcha_tpu_torch.data.batcher import BucketedBatcher
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.interop import params_from_numpy, params_to_numpy
from matcha_tpu_torch.models import hypersagnn as th
from matcha_tpu_torch.models import modules as tm
from matcha_tpu_torch.ops import fused_tail as ft
from matcha_tpu_torch.parallel import distributed as pd
from matcha_tpu_torch.parallel import mesh as pm
from matcha_tpu_torch.parallel import stream as ps
from matcha_tpu_torch.sampler.bloom import build_bloom_dict
from matcha_tpu_torch.sampler.negative import ChromTable
from matcha_tpu_torch.train import runtime as tr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
MESHES = [(2, 1), (1, 2), (2, 2)]
CASES = {"hybrid": dict(token_stream="hybrid"),
         "merged": dict(token_stream="merged"),
         "regress": dict(task_mode="regress")}
TP_CASES = ("hybrid", "regress")    # the pad-max stream, the padded forward
STEP_B = 16                      # positives per k of the deterministic step


def _problem():
    """tests/test_multichip.py's problem, with the port's params (drawn
    from a torch generator; JAX takes the same numpy tree)."""
    rng = np.random.default_rng(0)
    genome = GenomeBins(["chr1", "chr2", "chr3"],
                        [30_000_000, 22_000_000, 15_000_000], 1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    intra = intra + intra.T
    inter = rng.random((n, n)).astype(np.float32)
    kw = dict(dim=16, n_head=4, num_chroms=3, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    params = params_to_numpy(th.init_model(
        torch.Generator().manual_seed(0), th.ModelDims(**kw), sizes,
        device="cpu"))
    return genome, intra, inter, kw, params


def _buckets(n, seed, n_edges=256):
    r = np.random.default_rng(seed)
    out = {}
    for k in (2, 3):
        e = np.sort(r.choice(np.arange(1, n + 1), (n_edges, k)), axis=1)
        e = e[(np.diff(e, axis=1) > 0).all(axis=1)]
        out[k] = (e.astype(np.int32),
                  r.random(len(e)).astype(np.float32) + 0.5)
    return out


OCC = dict(feature_dropout_mode="per_occurrence", feature_dropout=0.2)


def _trainer(genome, intra, inter, kw, params, settings, blooms, mesh=None,
             tensor_parallel=False):
    return tr.Trainer(params_from_numpy(params, "cpu"),
                      th.build_frozen_tables(genome, intra, inter,
                                             device="cpu"),
                      th.ModelDims(**kw), ChromTable.from_genome(
                          genome, device="cpu"),
                      settings, blooms, seed=7, mesh=mesh,
                      tensor_parallel=tensor_parallel)


def _flat(params):
    return [t.detach().numpy().copy() for t in tr._leaves(params)]


def _identity_dropout(x, *args, **kwargs):
    return x


def _epoch_inputs(genome):
    train_b = _buckets(genome.num_nodes, 1)
    return train_b, build_bloom_dict({k: v[0] for k, v in train_b.items()},
                                     device="cpu")


def _run_case(settings, genome, intra, inter, kw, params, mesh=None,
              tensor_parallel=False):
    """Eval (fresh params), a host epoch, then -> results; the same calls
    on one rank and on a mesh ("whole": the params with whole leaves,
    "params" this rank's, blocks under tensor parallelism)."""
    train_b, blooms = _epoch_inputs(genome)
    t = _trainer(genome, intra, inter, kw, params, settings, blooms, mesh,
                 tensor_parallel)
    ev = t.eval_epoch(_buckets(genome.num_nodes, 9), batch_size=16,
                      max_samples=128, return_pred=True)
    r = t.train_epoch(BucketedBatcher(train_b, batch_size=16,
                                      num_batch_per_iter=4, seed=3))
    return {"eval_bce": ev["bce"], "eval_recon": ev["recon"],
            "eval_pred": ev.get("pred"), "bce": r["bce"], "recon": r["recon"],
            "params": _flat(t.params), "whole": _flat(t.whole_params())}


def _det_step(t, inp, mode, n_data, train=False):
    """The deterministic step of ``t`` on the fixed inputs under its mesh
    (the recon chromosome injected; ``train`` with a generator, for the
    per-occurrence embedding, with the other dropouts patched away by the
    caller), the gradients summed over the ranks -> loss, bce, recon, the
    predictions and the whole gradients."""
    n_world = 1 if t.mesh is None else t.mesh.size
    xs = {k: torch.from_numpy(inp[f"x{k}"]) for k in (2, 3)}
    batch = {k: (torch.from_numpy(inp[f"pos{k}"]),
                 torch.from_numpy(inp[f"w{k}"])) for k in (2, 3)}
    with pm.using_active_mesh(t.mesh):
        logits, recon = th.forward_buckets(
            t.params, t.frozen, t.dims, xs, return_recon=True,
            attention_mode=mode, recon_chrom=int(inp["r"]), n_shards=n_data,
            train=train,
            generator=torch.Generator().manual_seed(0) if train else None)
        bce, pred = tr._bucket_bce_and_preds(
            logits, batch, {k: b[1] for k, b in batch.items()}, n_data)
        loss = bce + 0.5 * recon
        (loss / n_world).backward()
    t._sum_grads()
    axes = t._tp_axes or [None] * len(tr._leaves(t.params))
    return {"loss": float(loss), "bce": float(bce), "recon": float(recon),
            "pred": pred.detach().numpy(),
            "grads": [pm.tp_gather(p.grad, a, t.mesh).numpy().copy()
                      for p, a in zip(tr._leaves(t.params), axes)]}


# ------------------------------------------------------------ rank worker
def _mesh_worker(rank, dev, n_data, n_model, tmp):
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pm.make_mesh(n_data, n_model)
    assert (mesh.data_index, mesh.model_index) == divmod(rank, n_model)
    genome, intra, inter, kw, params = _problem()
    world = n_data * n_model
    out = {}
    # put_global / replicate_to_host round trip (rows 5 per rank + 1)
    x = np.arange(3 * (5 * world + 1), dtype=np.int32).reshape(-1, 3)
    out["roundtrip"] = bool(np.array_equal(
        pd.replicate_to_host(pd.put_global(x, mesh), mesh, len(x)), x))
    # the encode with feature dropout, batched (3 chromosomes) and per
    # chromosome (1), against one process's on the whole tables
    out["encode"] = []
    for g in (genome, GenomeBins(["chr1"], [30_000_000], 1_000_000)):
        n = g.num_nodes
        p1 = th.init_model(torch.Generator().manual_seed(1), th.ModelDims(
            **dict(kw, num_chroms=g.num_chroms, num_nodes=n)),
            [int(e - s) for s, e in g.chrom_range], device="cpu")
        d1 = th.ModelDims(**dict(kw, num_chroms=g.num_chroms, num_nodes=n))
        f1 = th.build_frozen_tables(g, intra[:n, :n], inter[:n, :n],
                                    device="cpu")
        one = th.encode_node_table(p1, f1, d1, train=True,
                                   generator=torch.Generator().manual_seed(5))
        with pm.using_active_mesh(mesh):
            got = th.encode_node_table(
                p1, pm.shard_frozen(f1, mesh), d1, train=True,
                generator=torch.Generator().manual_seed(5))
        out["encode"].append((one.numpy(), got.detach().numpy()))
    # the deterministic step on JAX's negatives, replicated and with the
    # attention weights' heads on the model axis
    inp = np.load(os.path.join(tmp, "step_inputs.npz"))
    s0 = tr.TrainSettings(alpha=1.0, beta=0.001)
    for mode in ("per-k", "pad-max"):
        t = _trainer(genome, intra, inter, kw, params, s0, None, mesh)
        out["frozen_bytes"] = pm.frozen_nbytes(t.frozen)
        out[f"step_{mode}"] = _det_step(t, inp, mode, n_data)
        t = _trainer(genome, intra, inter, kw, params, s0, None, mesh,
                     tensor_parallel=True)
        out[f"tp_step_{mode}"] = _det_step(t, inp, mode, n_data)
        out["tp_shapes"] = [tuple(p.shape) for p in tr._leaves(t.params)]
    # per-occurrence at rate 0, the other dropouts the identity
    occ0 = dict(kw, feature_dropout_mode="per_occurrence", feature_dropout=0.0)
    keep = tm.dropout
    tm.dropout = _identity_dropout
    try:
        t = _trainer(genome, intra, inter, occ0, params, s0, None, mesh)
        out["occ_step"] = _det_step(t, inp, "per-k", n_data, train=True)
    finally:
        tm.dropout = keep
    # the autograd reduce-scatter of unequal blocks over the model group
    sizes = [3 + j for j in range(n_model)]
    x = torch.arange(sum(sizes) * 2, dtype=torch.float32).reshape(-1, 2)
    x = (x * (1 + mesh.rank)).requires_grad_(True)
    y = pm.reduce_scatter_blocks(x, sizes, mesh.model_group)
    (y * (1 + mesh.model_index)).sum().backward()
    want = sum(torch.arange(sum(sizes) * 2, dtype=torch.float32).reshape(
        -1, 2) * (1 + mesh.data_index * n_model + j) for j in range(n_model))
    lo = sum(sizes[:mesh.model_index])
    out["reduce_scatter"] = bool(
        torch.equal(y.detach(), want[lo:lo + sizes[mesh.model_index]])
        and torch.equal(x.grad, torch.cat([torch.full((n, 2), 1.0 + j)
                                           for j, n in enumerate(sizes)])))
    for case, knobs in CASES.items():
        out[case] = _run_case(tr.TrainSettings(alpha=1.0, beta=0.001,
                                               **knobs),
                              genome, intra, inter, kw, params, mesh)
    for case in TP_CASES:
        out[f"tp_{case}"] = _run_case(
            tr.TrainSettings(alpha=1.0, beta=0.001, **CASES[case]),
            genome, intra, inter, kw, params, mesh, tensor_parallel=True)
        out[f"occ_{case}"] = _run_case(
            tr.TrainSettings(alpha=1.0, beta=0.001, **CASES[case]),
            genome, intra, inter, dict(kw, **OCC), params, mesh)
    # indexed against host epochs on the mesh (test_multichip.py:237)
    train_b, blooms = _epoch_inputs(genome)
    s = tr.TrainSettings(alpha=1.0, beta=0.001)
    th_ = _trainer(genome, intra, inter, kw, params, s, blooms, mesh)
    ti = _trainer(genome, intra, inter, kw, params, s, blooms, mesh)
    b1 = BucketedBatcher(train_b, batch_size=16, num_batch_per_iter=3, seed=3)
    b2 = BucketedBatcher(train_b, batch_size=16, num_batch_per_iter=3, seed=3)
    rh = th_.train_epoch(b1)
    assert ti.pin_base_buckets(b2)
    ri = ti.train_epoch_indexed(b2)
    out["indexed"] = {"host": (rh["bce"], rh["recon"], _flat(th_.params)),
                      "indexed": (ri["bce"], ri["recon"], _flat(ti.params))}
    if world == 4:
        # an "orbax" fit on the mesh, stopped after epoch 1 and resumed
        fit_kw = dict(batch_size=16, num_batch_per_iter=2,
                      log=lambda *_: None, checkpoint_format="orbax")
        runs = []
        for name, epochs, resume in (("A", 3, False), ("B", 2, False),
                                     ("B", 3, True)):
            t = _trainer(genome, intra, inter, kw, params, s, blooms, mesh)
            hist = t.fit(train_b, train_b, epochs=epochs, resume=resume,
                         checkpoint_path=os.path.join(tmp, f"ck{name}"),
                         resume_path=os.path.join(tmp, f"res{name}"),
                         **fit_kw)
            runs.append(([h["train"]["bce"] for h in hist], _flat(t.params)))
        out["orbax"] = runs
        # tensor parallelism: an "orbax" and a pickle fit, stopped after
        # epoch 1 and resumed; the pickle checkpoint holds whole arrays
        for fmt in ("orbax", "pickle"):
            runs = []
            for name, epochs, resume in (("A", 3, False), ("B", 2, False),
                                         ("B", 3, True)):
                t = _trainer(genome, intra, inter, kw, params, s, blooms,
                             mesh, tensor_parallel=True)
                ext = "" if fmt == "orbax" else ".pkl"
                hist = t.fit(train_b, train_b, epochs=epochs, resume=resume,
                             checkpoint_path=os.path.join(
                                 tmp, f"tp_{fmt}_ck{name}{ext}"),
                             resume_path=os.path.join(
                                 tmp, f"tp_{fmt}_res{name}{ext}"),
                             **dict(fit_kw, checkpoint_format=fmt))
                runs.append(([h["train"]["bce"] for h in hist],
                             _flat(t.params), _flat(t.whole_params())))
            out[f"tp_{fmt}"] = runs
        out["tp_pickle_checkpoint"] = os.path.join(tmp, "tp_pickle_ckA.pkl")
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))


# ---------------------------------------------------------------- fixture
def _jax_step_inputs(genome, kw, params, n_data):
    """JAX-sampled negatives (against Bloom filters) and the recon
    chromosome, in the n_data shard-major layout."""
    import jax
    import jax.numpy as jnp
    from matcha_tpu.parallel.stream import shard_concat
    from matcha_tpu.sampler.bloom import build_bloom_dict as jbuild
    from matcha_tpu.sampler.negative import ChromTable as JTable
    from matcha_tpu.sampler.negative import sample_negatives as jsample
    from matcha_tpu.genome import GenomeBins as JGenome
    jg = JGenome(genome.chrom_names, genome.chrom_sizes, genome.resolution)
    train_b = _buckets(genome.num_nodes, 1)
    blooms = jbuild({k: v[0] for k, v in train_b.items()})
    out = {}
    for i, k in enumerate((2, 3)):
        e, w = train_b[k][0][:STEP_B], train_b[k][1][:STEP_B]
        neg = jsample(jax.random.PRNGKey(10 + i), jnp.asarray(e),
                      JTable.from_genome(jg), 0, blooms[k], neg_num=3)
        out[f"x{k}"] = np.asarray(shard_concat(
            [jnp.asarray(e), jnp.asarray(neg)], n_data))
        out[f"pos{k}"], out[f"w{k}"] = e, w
    kf = jax.random.PRNGKey(8)
    out["r"] = int(jax.random.randint(jax.random.split(kf, 4)[2], (), 0,
                                      kw["num_chroms"]))
    return out


def _jax_step(genome, intra, inter, kw, params, inp, n_data, n_model, mode,
              tensor_parallel=False, occurrence=False):
    """JAX's value_and_grad of the same step under make_mesh(D, M), with
    shard_train_inputs (the params then placed by ``param_sharding(...,
    tensor_parallel)``) and using_active_mesh.  occurrence: train mode
    with per-occurrence feature dropout at rate 0, the other dropouts the
    identity."""
    import jax
    import jax.numpy as jnp
    from matcha_tpu.genome import GenomeBins as JGenome
    from matcha_tpu.models import hypersagnn as jh
    from matcha_tpu.models import modules as jm
    from matcha_tpu.parallel.mesh import (make_mesh, param_sharding,
                                          shard_train_inputs,
                                          using_active_mesh)
    from matcha_tpu.train import runtime as jr
    jg = JGenome(genome.chrom_names, genome.chrom_sizes, genome.resolution)
    mesh = make_mesh(n_data, n_model,
                     devices=jax.devices()[:n_data * n_model])
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jp, jf, _ = shard_train_inputs(mesh, jp, jh.build_frozen_tables(
        jg, intra, inter), {})
    if tensor_parallel:
        jp = jax.device_put(jp, param_sharding(jp, mesh,
                                               tensor_parallel=True))
    jd = jh.ModelDims(**kw)
    if occurrence:
        jd = jd._replace(feature_dropout_mode="per_occurrence",
                         feature_dropout=0.0)
    xs = {k: jnp.asarray(inp[f"x{k}"]) for k in (2, 3)}
    batch = {k: (jnp.asarray(inp[f"pos{k}"]), jnp.asarray(inp[f"w{k}"]))
             for k in (2, 3)}
    kf = jax.random.PRNGKey(8)

    def loss(p):
        logits, recon = jh.forward_buckets(
            p, jf, jd, xs, key=kf, return_recon=True, attention_mode=mode,
            n_shards=n_data, train=occurrence)
        bce, pred = jr._bucket_bce_and_preds(
            logits, batch, {k: b[1] for k, b in batch.items()}, n_data)
        return bce + 0.5 * recon, {"bce": bce, "recon": recon, "pred": pred}

    keep = jm.dropout
    if occurrence:
        jm.dropout = lambda key, x, rate, train: x
    try:
        with using_active_mesh(mesh):
            (l, aux), g = jax.jit(jax.value_and_grad(loss,
                                                     has_aux=True))(jp)
    finally:
        jm.dropout = keep
    return {"loss": float(l), "bce": float(aux["bce"]),
            "recon": float(aux["recon"]), "pred": np.asarray(aux["pred"]),
            "grads": [np.asarray(a) for a in jax.tree_util.tree_leaves(g)]}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Start the three meshes' ranks, compute the JAX and single-rank
    references meanwhile, then gather every rank's results."""
    genome, intra, inter, kw, params = _problem()
    ctxs, dirs = {}, {}
    for d, m in MESHES:
        tmp = str(tmp_path_factory.mktemp(f"mesh{d}x{m}"))
        np.savez(os.path.join(tmp, "step_inputs.npz"),
                 **_jax_step_inputs(genome, kw, params, d))
        dirs[(d, m)] = tmp
        ctxs[(d, m)] = pd.spawn(_mesh_worker, d * m, d, m, tmp, join=False)
    refs = {}
    for d, m in MESHES:
        inp = np.load(os.path.join(dirs[(d, m)], "step_inputs.npz"))
        for mode in ("per-k", "pad-max"):
            refs[(d, m, mode)] = _jax_step(genome, intra, inter, kw, params,
                                           inp, d, m, mode)
            if m > 1:
                refs[(d, m, mode, "tp")] = _jax_step(
                    genome, intra, inter, kw, params, inp, d, m, mode,
                    tensor_parallel=True)
        refs[(d, m, "occ")] = _jax_step(genome, intra, inter, kw, params,
                                        inp, d, m, "per-k", occurrence=True)
    for d in sorted({d for d, _ in MESHES}):
        for case, knobs in CASES.items():
            refs[(d, case)] = _run_case(
                tr.TrainSettings(alpha=1.0, beta=0.001, n_shards=d, **knobs),
                genome, intra, inter, kw, params)
        for case in TP_CASES:
            refs[(d, "occ", case)] = _run_case(
                tr.TrainSettings(alpha=1.0, beta=0.001, n_shards=d,
                                 **CASES[case]),
                genome, intra, inter, dict(kw, **OCC), params)
    got = {}
    for key, ctx in ctxs.items():
        while not ctx.join():
            pass
        got[key] = [torch.load(os.path.join(dirs[key], f"rank{r}.pt"),
                               weights_only=False)
                    for r in range(key[0] * key[1])]
    return refs, got


# ------------------------------------------------------------ layout tests
@pytest.mark.parametrize("ns", [1, 2, 4])
def test_shard_concat_and_split_bit_equal_jax(ns):
    """shard_concat / shard_split equal JAX's bit for bit; divisible."""
    import jax.numpy as jnp
    from matcha_tpu.parallel import stream as js
    rng = np.random.default_rng(ns)
    sizes = [8, 4, 12]
    parts = [rng.standard_normal((n, 3)).astype(np.float32) for n in sizes]
    got = ps.shard_concat([torch.from_numpy(p) for p in parts], ns)
    ref = js.shard_concat([jnp.asarray(p) for p in parts], ns)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    for a, b, p in zip(ps.shard_split(got, ns, sizes),
                       js.shard_split(ref, ns, sizes), parts):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_array_equal(a.numpy(), p)
    assert ps.divisible(sizes, ns) == js.divisible(sizes, ns)
    assert ps.divisible([6, 4], 4) is js.divisible([6, 4], 4) is False
    pos = ps.stream_positions(sizes, ns, [(1, 5), (0, 4), (3, 12)])
    want = np.concatenate([parts[0][1:5], parts[1][0:4], parts[2][3:12]])
    np.testing.assert_array_equal(got.numpy()[pos.numpy()], want)


@pytest.mark.parametrize("mode", ["per-k", "pad-max"])
@pytest.mark.parametrize("ns", [2, 4])
def test_forward_buckets_n_shards_matches_jax(ns, mode):
    """forward_buckets(n_shards) against JAX's (logits rtol 1e-5, atol
    1e-6; recon 1e-5 relative), and a row permutation of the port's own
    ns = 1 output (same tolerance)."""
    import jax
    import jax.numpy as jnp
    from matcha_tpu.genome import GenomeBins as JGenome
    from matcha_tpu.models import hypersagnn as jh
    genome, intra, inter, kw, params = _problem()
    jg = JGenome(genome.chrom_names, genome.chrom_sizes, genome.resolution)
    rng = np.random.default_rng(4)
    xs = {k: np.sort(rng.choice(np.arange(1, genome.num_nodes + 1),
                                (16, k)), axis=1).astype(np.int32)
          for k in (2, 3, 5)}
    tp = params_from_numpy(params, "cpu")
    tf = th.build_frozen_tables(genome, intra, inter, device="cpu")
    td = th.ModelDims(**kw)
    kf = jax.random.PRNGKey(8)
    r = int(jax.random.randint(jax.random.split(kf, 4)[2], (), 0, 3))
    ref, jrec = jh.forward_buckets(
        jax.tree_util.tree_map(jnp.asarray, params),
        jh.build_frozen_tables(jg, intra, inter), jh.ModelDims(**kw),
        {k: jnp.asarray(v) for k, v in xs.items()}, key=kf,
        return_recon=True, attention_mode=mode, n_shards=ns)
    txs = {k: torch.from_numpy(v) for k, v in xs.items()}
    got, rec = th.forward_buckets(tp, tf, td, txs, return_recon=True,
                                  attention_mode=mode, recon_chrom=r,
                                  n_shards=ns)
    one = th.forward_buckets(tp, tf, td, txs, attention_mode=mode)
    for k in xs:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(ref[k]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   one[k].detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(float(rec), float(jrec), rtol=1e-5)
    # the stream itself: ns shard-major is a row permutation of ns = 1
    flat = [txs[k].reshape(-1) for k in sorted(xs)]
    sm = ps.shard_concat(flat, ns)
    pos = ps.stream_positions([f.numel() for f in flat], ns,
                              [(0, f.numel()) for f in flat])
    np.testing.assert_array_equal(sm[pos].numpy(), torch.cat(flat).numpy())


# ------------------------------------------------------------- mesh tests
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_encode_on_mesh_equals_one_process(worlds, mesh):
    """The node table with feature dropout on, from row-sharded feature
    tables (the model axis) and the whole draw's masks, equals one
    process's on the whole tables (rtol 1e-6, atol 1e-7): the batched
    encode (3 chromosomes) and the per-chromosome loop (1)."""
    _, got = worlds
    for rank_out in got[mesh]:
        for one, sharded in rank_out["encode"]:
            np.testing.assert_allclose(sharded, one, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_step_on_mesh_matches_jax_mesh(worlds, mesh):
    """The deterministic step of W ranks, gradients summed over the ranks,
    against JAX's value_and_grad under make_mesh(D, M), per-k and pad-max
    (rtol 1e-4, atol 1e-5)."""
    refs, got = worlds
    for mode in ("per-k", "pad-max"):
        ref = refs[mesh + (mode,)]
        for rank_out in got[mesh]:
            out = rank_out[f"step_{mode}"]
            for name in ("loss", "bce", "recon"):
                np.testing.assert_allclose(out[name], ref[name], **TOL,
                                           err_msg=f"{mode} {name}")
            np.testing.assert_allclose(out["pred"], ref["pred"], **TOL)
            assert len(out["grads"]) == len(ref["grads"])
            for a, b in zip(out["grads"], ref["grads"]):
                np.testing.assert_allclose(a, b, **TOL, err_msg=mode)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_epoch_on_mesh_matches_one_rank_with_n_shards(worlds, mesh):
    """train_epoch on W ranks against one rank with n_shards = D, the same
    seed, dropout on, both token streams and the regress mode: bce 1e-4,
    recon 2e-3, params rtol 5e-3 / atol 5e-4 (tests/test_multichip.py:80-92);
    every rank holds the same params bit for bit."""
    refs, got = worlds
    for stream in CASES:
        ref = refs[(mesh[0], stream)]
        for rank_out in got[mesh]:
            out = rank_out[stream]
            assert abs(out["bce"] - ref["bce"]) < 1e-4, stream
            assert abs(out["recon"] - ref["recon"]) < 2e-3, stream
            for a, b in zip(out["params"], ref["params"]):
                np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4)
        for rank_out in got[mesh][1:]:
            for a, b in zip(rank_out[stream]["params"],
                            got[mesh][0][stream]["params"]):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_eval_on_mesh_matches_one_rank(worlds, mesh):
    """Mesh eval (test_multichip.py:194; the regress mode's per-k eval too):
    predictions gathered to every rank equal one rank's (the batch cut to a
    multiple of D; rtol 1e-5, atol 1e-6), and so do bce and recon."""
    refs, got = worlds
    for stream in CASES:
        ref = refs[(mesh[0], stream)]
        for rank_out in got[mesh]:
            out = rank_out[stream]
            assert np.isfinite(out["eval_bce"])
            if ref["eval_pred"] is not None:
                np.testing.assert_allclose(out["eval_pred"],
                                           ref["eval_pred"], rtol=1e-5,
                                           atol=1e-6)
            np.testing.assert_allclose(out["eval_bce"], ref["eval_bce"],
                                       rtol=1e-5)
            np.testing.assert_allclose(out["eval_recon"], ref["eval_recon"],
                                       rtol=1e-5)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_indexed_matches_host_on_mesh(worlds, mesh):
    """Indexed epochs (base arrays pinned on every rank) against host
    epochs on the same mesh (test_multichip.py:237): bce 1e-6, recon 1e-4,
    params rtol 1e-6 / atol 1e-7; put_global / replicate_to_host round
    trip; the frozen tables' bytes per rank fall on the model axis."""
    _, got = worlds
    for rank_out in got[mesh]:
        (hb, hr, hp), (ib, ir, ip) = (rank_out["indexed"]["host"],
                                      rank_out["indexed"]["indexed"])
        assert abs(hb - ib) < 1e-6 and abs(hr - ir) < 1e-4
        for a, b in zip(hp, ip):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)
        assert rank_out["roundtrip"]
    if mesh[1] > 1:
        assert got[mesh][0]["frozen_bytes"] < got[(2, 1)][0]["frozen_bytes"]


def test_orbax_fit_resumes_exactly_on_a_mesh(worlds):
    """Trainer.fit(checkpoint_format="orbax") on the 2x2 mesh (every rank
    saves and restores): stopped after epoch 1 and resumed in fresh
    Trainers, the last epoch's bce and the params equal the uninterrupted
    run's (1e-6; rtol 1e-6 / atol 1e-7), on every rank."""
    _, got = worlds
    for rank_out in got[(2, 2)]:
        (bce_a, pa), (bce_b1, _), (bce_b2, pb) = rank_out["orbax"]
        assert len(bce_a) == 3 and len(bce_b1) == 2 and len(bce_b2) == 1
        assert abs(bce_a[2] - bce_b2[0]) < 1e-6
        for x, y in zip(pa, pb):
            np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)


def _assert_step(out, ref, what):
    for name in ("loss", "bce", "recon"):
        np.testing.assert_allclose(out[name], ref[name], **TOL,
                                   err_msg=f"{what} {name}")
    np.testing.assert_allclose(out["pred"], ref["pred"], **TOL)
    assert len(out["grads"]) == len(ref["grads"])
    for a, b in zip(out["grads"], ref["grads"]):
        np.testing.assert_allclose(a, b, **TOL, err_msg=what)


def _leaf_names(tree, path=""):
    """"/"-joined key paths of the leaves, in ``_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k],
                                                             f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree)
                for n in _leaf_names(v, f"{path}/{i}")]
    return [path[1:]]


# the key LayerNorm's bias adds one vector to every key of an edge, which
# adds a constant to each score row that the softmax removes: its gradient
# is zero but for rounding, and AdamW turns that noise into steps of up to
# about lr each, in directions the summation order picks
NULL_GRAD = "encoder/mha/ln_k/b"


def _assert_epoch(out, ref, what, steps=4, lr=1e-3):
    """An epoch against one rank's (tests/test_multichip.py:80-92): bce
    1e-4, recon 2e-3, the whole params rtol 5e-3 / atol 5e-4; the leaf
    whose gradient is zero but for rounding (NULL_GRAD) within the two
    runs' noise steps, 2 * steps * lr."""
    assert abs(out["bce"] - ref["bce"]) < 1e-4, what
    assert abs(out["recon"] - ref["recon"]) < 2e-3, what
    names = _leaf_names(_problem()[4])
    for name, a, b in zip(names, out["whole"], ref["params"]):
        if name == NULL_GRAD:
            assert np.abs(a - b).max() <= 2 * steps * lr, (what, name)
        else:
            np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-4,
                                       err_msg=f"{what} {name}")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_step_matches_jax_mesh(worlds, mesh):
    """The deterministic f32 step with the attention weights' heads on the
    model axis, per-k and pad-max, the sharded gradients gathered over the
    model group, against JAX's value_and_grad under make_mesh(D, M) with
    param_sharding(..., tensor_parallel=True) (rtol 1e-4, atol 1e-5); on
    2 x 1 (no model axis) it is the replicated step, bit for bit.  The
    rank holds 1/M of wq, wk, wv (columns) and fc1's weight (rows)."""
    refs, got = worlds
    for rank_out in got[mesh]:
        for mode in ("per-k", "pad-max"):
            out = rank_out[f"tp_step_{mode}"]
            if mesh[1] == 1:
                dp = rank_out[f"step_{mode}"]
                assert out["loss"] == dp["loss"]
                for a, b in zip(out["grads"], dp["grads"]):
                    np.testing.assert_array_equal(a, b)
            else:
                _assert_step(out, refs[mesh + (mode, "tp")], f"tp {mode}")
        whole = [tuple(g.shape) for g in rank_out["step_per-k"]["grads"]]
        for held, full in zip(rank_out["tp_shapes"], whole):
            cut = [i for i, (a, b) in enumerate(zip(held, full)) if a != b]
            assert all(held[i] * mesh[1] == full[i] for i in cut)
        assert sum(a != b for a, b in zip(rank_out["tp_shapes"], whole)) \
            == (0 if mesh[1] == 1 else 4)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_tensor_parallel_epoch_matches_one_rank_with_n_shards(worlds, mesh):
    """A tensor-parallel epoch (dropout on; the pad-max stream and the
    regress mode's padded forward) against one rank with n_shards = D:
    bce 1e-4, recon 2e-3, the whole params rtol 5e-3 / atol 5e-4, the eval
    predictions 1e-5; replicated leaves bit-equal on every rank, sharded
    leaves bit-equal across each data group (the ranks of one model
    index); the reduce-scatter of unequal blocks and its backward exact."""
    refs, got = worlds
    ranks = got[mesh]
    for case in TP_CASES:
        ref = refs[(mesh[0], case)]
        for rank_out in ranks:
            out = rank_out[f"tp_{case}"]
            _assert_epoch(out, ref, case)
            if ref["eval_pred"] is not None:
                np.testing.assert_allclose(out["eval_pred"],
                                           ref["eval_pred"], rtol=1e-5,
                                           atol=1e-6)
            assert rank_out["reduce_scatter"]
        for r, rank_out in enumerate(ranks):
            peer = ranks[r % mesh[1]][f"tp_{case}"]
            for a, b in zip(rank_out[f"tp_{case}"]["params"],
                            peer["params"]):
                np.testing.assert_array_equal(a, b)
            for a, b in zip(rank_out[f"tp_{case}"]["whole"],
                            ranks[0][f"tp_{case}"]["whole"]):
                np.testing.assert_array_equal(a, b)


def test_tensor_parallel_checkpoints_resume_and_hold_whole_arrays(worlds):
    """On 2 x 2 with tensor parallelism: an "orbax" fit and a pickle fit,
    stopped after epoch 1 and resumed in fresh Trainers, end as the
    uninterrupted runs do (bce 1e-6; params rtol 1e-6 / atol 1e-7) on
    every rank; the pickle checkpoint holds whole arrays, equal to the
    fit's gathered params (the best epoch reloaded), and loads in a no-mesh
    port Trainer and in JAX."""
    import jax
    from matcha_tpu.train import runtime as jr
    _, got = worlds
    for fmt in ("orbax", "pickle"):
        for rank_out in got[(2, 2)]:
            (bce_a, pa, wa), (bce_b1, _, _), (bce_b2, pb, wb) = \
                rank_out[f"tp_{fmt}"]
            assert len(bce_a) == 3 and len(bce_b1) == 2 and len(bce_b2) == 1
            assert abs(bce_a[2] - bce_b2[0]) < 1e-6, fmt
            for x, y in zip(pa + wa, pb + wb):
                np.testing.assert_allclose(x, y, rtol=1e-6, atol=1e-7)
    ck = got[(2, 2)][0]["tp_pickle_checkpoint"]
    whole = got[(2, 2)][0]["tp_pickle"][0][2]
    loaded = tr.load_checkpoint(ck, full=True, device="cpu")
    assert loaded["epoch"] is not None
    for a, b in zip(_flat(loaded["params"]), whole):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(loaded["opt_state"]["exp_avg"], whole):
        assert a.shape == b.shape
    for a, b in zip(jax.tree_util.tree_leaves(jr.load_checkpoint(ck)),
                    whole):
        np.testing.assert_array_equal(np.asarray(a), b)
    genome, intra, inter, kw, _ = _problem()
    t = _trainer(genome, intra, inter, kw, params_to_numpy(loaded["params"]),
                 tr.TrainSettings(alpha=1.0, beta=0.001), None)
    for a, b in zip(_flat(t.params), whole):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_per_occurrence_step_on_mesh_matches_jax_mesh(worlds, mesh):
    """Per-occurrence feature dropout on the meshes: the train-mode step at
    rate 0 (the attention and feed-forward dropouts the identity on both
    sides; the per-token embedding, gathered under a model axis by its
    holders and reduce-scattered, and the per-token recon summed over the
    world) against JAX's value_and_grad under make_mesh(D, M) (rtol 1e-4,
    atol 1e-5)."""
    refs, got = worlds
    for rank_out in got[mesh]:
        _assert_step(rank_out["occ_step"], refs[mesh + ("occ",)], "occ")


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_per_occurrence_epoch_on_mesh_matches_one_rank(worlds, mesh):
    """A per-occurrence epoch (feature dropout 0.2, the masks one draw per
    token of the whole stream) on the mesh against one rank with n_shards
    = D: bce 1e-4, recon 2e-3, params rtol 5e-3 / atol 5e-4; every rank
    holds the same params bit for bit."""
    refs, got = worlds
    for case in TP_CASES:
        ref = refs[(mesh[0], "occ", case)]
        for rank_out in got[mesh]:
            _assert_epoch(rank_out[f"occ_{case}"], ref, f"occ {case}")
        for rank_out in got[mesh][1:]:
            for a, b in zip(rank_out[f"occ_{case}"]["params"],
                            got[mesh][0][f"occ_{case}"]["params"]):
                np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------- single process
def test_mesh_rules_in_one_process():
    """A world of one: the 1x1 mesh is no mesh; kernel axes and batch
    factor follow JAX's rules; tensor_parallel without a mesh is the
    no-mesh Trainer (JAX places params by a mesh only), and its placement
    rule is JAX's param_sharding's; the frozen tables pad and shard by
    rows."""
    from matcha_tpu.parallel import mesh as jm
    one = pm.make_mesh(1, 1)
    assert one.shape == {"data": 1, "model": 1} and one.world is None
    with pm.using_active_mesh(one):
        assert pm.active_data_mesh() is None
    assert pm.active_data_mesh() is None

    class Fake:
        def __init__(self, d, m):
            self.shape, self.size = {"data": d, "model": m}, d * m
    for d, m in ((4, 2), (8, 1), (1, 2)):
        jmesh = type("M", (), {"shape": {"data": d, "model": m}})()
        assert pm.kernel_axes(Fake(d, m)) == jm.kernel_axes(jmesh)
        assert pm.kernel_batch_factor(Fake(d, m)) == d * m
    with pm.using_active_mesh(Fake(2, 1)):
        assert pm.active_data_mesh() is not None
    genome, intra, inter, kw, params = _problem()
    runs = []
    for tp in (False, True):
        t = _trainer(genome, intra, inter, kw, params,
                     tr.TrainSettings(alpha=1.0, beta=0.001), None,
                     tensor_parallel=tp)
        r = t.train_epoch(BucketedBatcher(_buckets(genome.num_nodes, 1),
                                          batch_size=16,
                                          num_batch_per_iter=2, seed=3))
        runs.append((r["bce"], r["recon"], _flat(t.params),
                     _flat(t.whole_params())))
    assert runs[0][:2] == runs[1][:2]
    for a, b in zip(runs[0][2] + runs[0][3], runs[1][2] + runs[1][3]):
        np.testing.assert_array_equal(a, b)
    # the placement rule, leaf by leaf, against JAX's param_sharding
    import jax
    from jax.sharding import PartitionSpec as P
    spec = {P(None, "model"): 1, P("model", None): 0, P(): None}
    jmesh = jm.make_mesh(1, 2, devices=jax.devices()[:2])
    want = [spec[x.spec] for x in jax.tree_util.tree_leaves(
        jm.param_sharding(params, jmesh, tensor_parallel=True))]
    assert pm.tp_axes(params_from_numpy(params, "cpu")) == want
    assert sorted(set(want), key=str) == [0, 1, None]
    odd = Fake(1, 3)
    odd.world = None
    with pytest.raises(ValueError, match="heads do not split"):
        pm.replicate_params(params_from_numpy(params, "cpu"), odd,
                            tensor_parallel=True, n_head=kw["n_head"])
    frozen = th.build_frozen_tables(genome, intra, inter, device="cpu")
    fake = Fake(1, 4)
    fake.model_index = 3
    padded = pm.pad_frozen_for_mesh(frozen, fake)
    assert all(f.shape[0] % 4 == 0 for f in padded.features)
    assert padded.inter_z.shape[0] % 4 == 0
    block = pm.shard_frozen(frozen, fake)
    np.testing.assert_array_equal(
        block.inter_z.numpy(),
        padded.inter_z[3 * padded.inter_z.shape[0] // 4:].numpy())
    assert pm.frozen_nbytes(block) < pm.frozen_nbytes(frozen)


def test_fused_tail_sharded_masks_offset_the_seed_by_the_data_index():
    """K6's masks of data shard d are the plain masks at seed + d * 2^20 over
    the rank's local token index (the JAX package's rule, the data index
    only: two model ranks of one data row draw the same stream)."""
    rng = np.random.default_rng(3)
    T, d = 24, ft.D
    args = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((T, d), (T, d))]
    w = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.1)
         for s in ((d, d), (d,), (d, d), (d,), (d, 1), (1,))]
    ln6 = torch.ones(6, d)
    for data_index, model_index in ((0, 0), (1, 0), (1, 1), (3, 1)):
        mesh = type("M", (), {"data_index": data_index,
                              "model_index": model_index})()
        got = ft.fused_tail_sharded(*args, ln6, *w, 11, 0.3, 0.4, True, mesh)
        want = ft.fused_tail(*args, ln6, *w,
                             11 + data_index * ft.SHARD_SEED_STRIDE,
                             0.3, 0.4, True)
        np.testing.assert_array_equal(got.numpy(), want.numpy())
        m0, m1 = ft.tail_masks(11 + data_index * (1 << 20), T, d, 0.3, 0.4,
                               True, "cpu")
        assert m0 is not None and 0.5 < float((m0 > 0).float().mean()) < 0.9


def test_init_distributed_is_a_noop_for_one_process(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert pd.init_distributed() is None
    assert not torch.distributed.is_initialized()
    mesh = pd.global_mesh(n_model=1)
    assert mesh.shape == {"data": 1, "model": 1}
    x = np.arange(12).reshape(4, 3)
    np.testing.assert_array_equal(
        pd.replicate_to_host(pd.put_global(x, mesh), mesh), x)


def test_init_distributed_raises_when_a_cluster_is_asked_for_late(
        monkeypatch, tmp_path):
    """A process group of one already up, then WORLD_SIZE=2: the cluster
    is lost, so init_distributed raises rather than train alone."""
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{tmp_path / 'store'}", rank=0,
        world_size=1)
    try:
        monkeypatch.setenv("WORLD_SIZE", "2")
        with pytest.raises(RuntimeError, match="already initialized"):
            pd.init_distributed()
    finally:
        torch.distributed.destroy_process_group()


# ----------------------------------------------------------------- CLI
def _fixture_config(tmp, stage2_epochs=2, **extra):
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from synth import make_synthetic_dataset, write_chrom_sizes
    rng = np.random.default_rng(3)
    genome = GenomeBins(["chr1", "chr2"], [30_000_000, 20_000_000],
                        1_000_000)
    cl, mc = make_synthetic_dataset(tmp, genome, rng, n_clusters=3000)
    cfg = {"cluster_path": cl, "mcool_path": mc, "resolution": 1_000_000,
           "chrom_list": genome.chrom_names,
           "chrom_size": write_chrom_sizes(tmp, genome),
           "temp_dir": str(tmp / "temp"), "max_cluster_size": 25,
           "min_distance": 0, "k-mer_size": [2, 3], "min_freq_cutoff": 2,
           "quantile_cutoff_for_positive": 0.6,
           "quantile_cutoff_for_unlabel": 0.4, "embed_dim": 16,
           "n_head": 4, "batch_size": 32, "num_batch_per_iter": 4,
           "stage1_epochs": 1, "stage2_epochs": stage2_epochs, **extra}
    path = tmp / "config.JSON"
    path.write_text(json.dumps(cfg))
    return str(path)


def test_run_train_with_a_mesh_raises_without_its_world(tmp_path,
                                                        monkeypatch):
    from matcha_tpu_torch.config import load_config
    from matcha_tpu_torch.pipeline import run_train
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    cfg = load_config(_fixture_config(tmp_path, mesh_data=2))
    with pytest.raises(RuntimeError, match="torchrun"):
        run_train(cfg, "cpu")


def test_torchrun_train_equals_one_rank_with_n_shards(tmp_path, monkeypatch):
    """torchrun --nproc-per-node 2 -m matcha_tpu_torch train --device cpu
    with mesh_data = 2: rank 0's metrics log equals a one-rank run with
    n_shards = 2 (bce 1e-4, recon 2e-3 per epoch); only rank 0 logs."""
    from matcha_tpu_torch.config import load_config
    from matcha_tpu_torch.pipeline import main, run_train
    mesh_dir, one_dir = tmp_path / "mesh", tmp_path / "one"
    mesh_dir.mkdir()
    one_dir.mkdir()
    cfg_mesh = _fixture_config(mesh_dir, mesh_data=2)
    cfg_one = _fixture_config(one_dir)
    for cfg in (cfg_mesh, cfg_one):
        main(["process", "-c", cfg])
        main(["kmers", "-c", cfg])
    env = {k: v for k, v in os.environ.items()
           if k not in ("WORLD_SIZE", "RANK", "LOCAL_RANK")}
    env["PYTHONPATH"] = ROOT
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--master-port", str(pd.free_port()), "-m",
         "matcha_tpu_torch", "train", "-c", cfg_mesh, "--device", "cpu"],
        cwd=str(mesh_dir), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("train sizes:") == 1        # rank 0 logs
    assert res.stdout.count("] valid bce") == 3         # one per epoch
    import matcha_tpu_torch.pipeline as pl
    settings = pl.TrainSettings
    monkeypatch.setattr(pl, "TrainSettings",
                        lambda *a, **k: settings(*a, **k, n_shards=2))
    run_train(load_config(cfg_one), "cpu", log=lambda *a: None)

    def epochs(d):
        with open(os.path.join(d, "temp", "logs", "metrics.jsonl")) as f:
            return [json.loads(line) for line in f]
    a, b = epochs(mesh_dir), epochs(one_dir)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        for part in ("train", "valid"):
            assert abs(x[f"{part}_bce"] - y[f"{part}_bce"]) < 1e-4
            assert abs(x[f"{part}_recon"] - y[f"{part}_recon"]) < 2e-3
