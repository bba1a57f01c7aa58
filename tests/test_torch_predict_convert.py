"""The scoring app's conversion (``apps/predict.py:predict_logits``) on the
CPU, against the per-candidate loop it replaced, kept here as the plain
version: the candidates bucketed by size in a Python loop (sizes in the
order they first appear, input order within a size), one int64 array per
size, its chunks of ``batch_size`` copied one by one.

For every input form the same chunks reach ``forward`` in the same order
and the logits are equal bit for bit.  The request unit counts the route
the input took (``convert.array`` or ``convert.ragged``), one copy to the
device and one sync, ``fetch``; an empty input copies nothing.
"""

from typing import Dict, List

import numpy as np
import pytest
import torch

from matcha_tpu_torch import telemetry
from matcha_tpu_torch.apps import predict as pr
from matcha_tpu_torch.genome import GenomeBins
from matcha_tpu_torch.models import hypersagnn as th


@pytest.fixture(scope="module")
def model():
    rng = np.random.default_rng(7)
    genome = GenomeBins(["chr1", "chr2"], [20_000_000, 14_000_000],
                        1_000_000)
    n = genome.num_nodes
    intra = rng.random((n, n)).astype(np.float32)
    inter = rng.random((n, n)).astype(np.float32)
    dims = th.ModelDims(dim=16, n_head=4, num_chroms=2, num_nodes=n)
    sizes = [int(e - s) for s, e in genome.chrom_range]
    return {"params": th.init_model(torch.Generator().manual_seed(0), dims,
                                    sizes, device="cpu"),
            "frozen": th.build_frozen_tables(genome, intra + intra.T, inter,
                                             device="cpu"),
            "dims": dims, "n": n}


def plain_predict_logits(params, frozen, dims, samples, batch_size,
                         forward=th.forward):
    """The conversion as it was: a Python loop over the candidates."""
    with torch.inference_mode():
        samples = list(samples)
        out = np.zeros(len(samples), dtype=np.float32)
        device = frozen.attr_table.device
        by_size: Dict[int, List[int]] = {}
        for i, s in enumerate(samples):
            by_size.setdefault(len(s), []).append(i)
        parts = []
        node_table = th.encode_node_table(params, frozen, dims)
        for idx in by_size.values():
            arr = torch.as_tensor(np.asarray([samples[i] for i in idx],
                                             dtype=np.int64))
            for lo in range(0, len(arr), batch_size):
                chunk = arr[lo:lo + batch_size].to(device)
                logits = forward(params, frozen, dims, chunk,
                                 node_table=node_table)
                parts.append((idx[lo:lo + batch_size], logits.reshape(-1)))
        if parts:
            host = torch.cat([p[1] for p in parts]).cpu()
            out[np.concatenate([np.asarray(p[0]) for p in parts])] = (
                host.numpy())
        return out


def _rows(rng, n, k, count):
    return [np.sort(rng.choice(np.arange(1, n + 1), k, replace=False))
            for _ in range(count)]


def _ragged(rng, n, per_k=(9, 6, 11, 5)):
    rows = [r for k, c in zip((2, 3, 4, 5), per_k)
            for r in _rows(rng, n, k, c)]
    return [rows[i] for i in rng.permutation(len(rows))]


def _lists(rows):
    return [r.tolist() for r in rows]


# name -> (the candidates, from a generator and the node count; the form
# the program is handed them in; batch size; the route's count, or None
# for no copy at all)
CASES = {
    "ragged_lists": (lambda g, n: _lists(_ragged(g, n)), None, 4,
                     "convert.ragged"),
    "tuples": (lambda g, n: _lists(_ragged(g, n)),
               lambda x: tuple(map(tuple, x)), 4, "convert.ragged"),
    "numpy_rows": (lambda g, n: _ragged(g, n), None, 4, "convert.ragged"),
    "generator": (lambda g, n: _lists(_ragged(g, n)),
                  lambda x: (r for r in x), 4, "convert.ragged"),
    "one_size_lists": (lambda g, n: _lists(_rows(g, n, 3, 13)), None, 5,
                       "convert.ragged"),
    "array_int64": (lambda g, n: np.stack(_rows(g, n, 2, 17)), None, 4,
                    "convert.array"),
    "array_int32": (lambda g, n: np.stack(_rows(g, n, 4, 9)).astype(
        np.int32), None, 4, "convert.array"),
    "several_chunks": (lambda g, n: _lists(_ragged(g, n, (23, 7, 31, 2))),
                       None, 6, "convert.ragged"),
    "single_candidate": (lambda g, n: [[1, 5, 9]], None, 4,
                         "convert.ragged"),
    "empty": (lambda g, n: [], None, 4, None),
    "empty_array": (lambda g, n: np.zeros((0, 3), np.int64), None, 4, None),
}


def _recorder(seen):
    def fwd(params, frozen, dims, x, **kw):
        seen.append(x.clone())
        return th.forward(params, frozen, dims, x, **kw)
    return fwd


@pytest.mark.parametrize("case", sorted(CASES))
def test_predict_logits_equals_the_loop(model, case, monkeypatch):
    make, form, batch_size, route = CASES[case]
    samples = make(np.random.default_rng(sorted(CASES).index(case)),
                   model["n"])
    args = (model["params"], model["frozen"], model["dims"])
    want_chunks, got_chunks = [], []
    want = plain_predict_logits(*args, samples, batch_size,
                                forward=_recorder(want_chunks))
    monkeypatch.setattr(pr, "forward", _recorder(got_chunks))
    telemetry.reset()
    got = pr.predict_logits(*args, form(samples) if form else samples,
                            batch_size=batch_size)
    req, = telemetry.units("request")

    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    assert len(got_chunks) == len(want_chunks)
    for a, b in zip(got_chunks, want_chunks):
        assert a.dtype == b.dtype == torch.int64
        assert torch.equal(a, b)
    if route is None:
        assert got.shape == (0,) and not got_chunks
        assert req.counts.get("copies", 0) == 0 and req.syncs == {}
    else:
        assert req.counts == {route: 1, "copies": 1}
        assert req.syncs == {"fetch": 1}

