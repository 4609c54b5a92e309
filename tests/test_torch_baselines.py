"""The port's PQ and RaBitQ baselines (``repro_torch.core.baselines``) on the
CPU against the JAX package's (``repro.core.baselines``, host numpy).

Data: the ``unit`` dataset (2,000 x 64) and a 20,000 x 128 slice of the
port's ``sift`` rows, made once with the port's generator and handed to both
packages as the same numpy arrays (the reference's ``make_dataset`` salts
its seed with ``hash(name)``); l2 and ip.  The ``sift`` fits take 2 Lloyd
steps on 2,000 sampled rows (the reference's pure-numpy encoding of 20,000
rows is most of this file's time).

Bounds, stated before the first run:

- ``fit_pq`` at n_sub of D/16, D/8 and D/4: the sampled rows identical (a
  fit of 0 Lloyd steps gives the reference's codebooks bit for bit: its
  centroids are the drawn rows); codebooks within rtol 1e-5 / atol 1e-6;
  codes equal on >= 99.9% of rows, and every differing row's two centroid
  distances within 1e-6 relative of each other (a float32 tie).
- Encoding and ``pq_distances`` from a reference ``PQ`` carried across:
  codes equal outside such ties; distances within rtol 1e-5.
- ``fit_rabitq``: the rotation bit-equal; ``center``, ``norms`` and
  ``ip_unit`` within rtol 1e-5; packed signs equal on >= 99.9% of bits;
  ``rabitq_estimate`` from a carried-across ``RaBitQ`` within rtol 1e-5;
  ``bits_per_vector`` equal.
- Fewer than 256 rows (centroids drawn with replacement, so some clusters
  stay empty): the PQ bounds above; two fits of one seed equal bit for bit.

The port sums in numpy's float32 order (``baselines.np_sum``), so its
codebooks, codes and ADC distances come out bit-equal; the bounds are the
ones stated.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import baselines as R
from repro_torch.core import baselines as P
from repro_torch.core import baselines_check as bc
from repro_torch.data.synthetic import DATASETS, _generate

CB_RTOL, CB_ATOL = 1e-5, 1e-6
CODE_SHARE = 0.999
TIE_REL = 1e-6
RTOL = 1e-5
FITS = {"unit": dict(iters=4), "sift": dict(iters=2, sample=2000)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch on one thread (restored afterwards)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    """{name: (rows, queries)}: unit whole, sift's first 20,000 rows."""
    out = {}
    for name, rows in (("unit", None), ("sift", 20_000)):
        d = _generate(DATASETS[name], 0, device="cpu")
        out[name] = (np.ascontiguousarray(d["vectors"][:rows]), d["queries"][:4])
    return out


@pytest.fixture(scope="module")
def pq_fits(data):
    """(dataset, n_sub) -> (reference PQ, port PQ), each fitted once."""
    cache = {}

    def get(name, n_sub):
        if (name, n_sub) not in cache:
            x = data[name][0]
            cache[name, n_sub] = (R.fit_pq(x, n_sub, **FITS[name]),
                                  P.fit_pq(x, n_sub, device="cpu", **FITS[name]))
        return cache[name, n_sub]
    return get


def n_subs(name):
    d = DATASETS[name].dim
    return [d // 16, d // 8, d // 4]


CASES = [(name, n) for name in ("unit", "sift") for n in n_subs(name)]


def test_comparisons_use_the_stated_bounds():
    """``core.baselines_check`` (the comparisons below, and the card's
    against the CPU's) holds these bounds."""
    assert (bc.CB_RTOL, bc.CB_ATOL, bc.CODE_SHARE, bc.TIE_REL, bc.RTOL) == \
        (CB_RTOL, CB_ATOL, CODE_SHARE, TIE_REL, RTOL)


def check_codes(got, want, codebooks, x):
    """Codes equal on >= 99.9% of rows; at every differing (row, sub-space)
    the two centroids' distances to the row tie within TIE_REL."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    bc.codes_agree(got, want, codebooks, x)


@pytest.mark.parametrize("n_sub_of", [16, 8, 4])
def test_pq_draws_same_rows(data, n_sub_of):
    """0 Lloyd steps: the codebooks are the drawn rows themselves (a sample
    smaller than the rows, so the draw without replacement matters)."""
    x = data["unit"][0]
    n_sub = x.shape[1] // n_sub_of
    want = R.fit_pq(x, n_sub, iters=0, sample=1000, seed=3)
    got = P.fit_pq(x, n_sub, iters=0, sample=1000, seed=3, device="cpu")
    assert np.array_equal(got.codebooks.numpy(), want.codebooks)
    assert np.array_equal(P.pq_codebooks(x, n_sub, iters=0, sample=1000, seed=3,
                                         device="cpu").numpy(), want.codebooks)


@pytest.mark.parametrize("name,n_sub", CASES)
def test_fit_pq_matches(data, pq_fits, name, n_sub):
    want, got = pq_fits(name, n_sub)
    x = data[name][0]
    np.testing.assert_allclose(got.codebooks.numpy(), want.codebooks, rtol=CB_RTOL,
                               atol=CB_ATOL)
    check_codes(got.codes.numpy(), want.codes, want.codebooks, x)
    assert got.d_sub == want.d_sub and got.metric == want.metric
    assert got.bits_per_vector == want.bits_per_vector
    # the reference's codebooks carried across encode to its codes
    carried = P.pq_from_numpy(want, device="cpu")
    check_codes(P.pq_encode(carried.codebooks, x).numpy(), want.codes, want.codebooks, x)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name,n_sub", CASES)
def test_pq_adc_from_reference_state(data, pq_fits, name, n_sub, metric):
    x, queries = data[name]
    want = dataclasses.replace(pq_fits(name, n_sub)[0], metric=metric)
    got = P.pq_from_numpy(want, device="cpu")
    ids = np.random.default_rng(1).integers(0, len(x), 3000)      # repeats included
    for q in queries:
        for sel in (ids, np.arange(len(x))):
            np.testing.assert_allclose(P.pq_distances(got, q, sel).numpy(),
                                       R.pq_distances(want, q, sel), rtol=RTOL)
    back = P.pq_to_numpy(got)
    assert np.array_equal(R.PQ(**back).codes, want.codes)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("name", ["unit", "sift"])
def test_fit_rabitq_matches(data, name, metric):
    x, queries = data[name]
    want = R.fit_rabitq(x, metric, seed=2)
    got = P.fit_rabitq(x, metric, seed=2, device="cpu")
    assert np.array_equal(got.rotation.numpy(), want.rotation)
    for f in ("center", "norms", "ip_unit"):
        a, b = getattr(got, f).numpy(), getattr(want, f)
        assert a.dtype == b.dtype == np.float32, f
        np.testing.assert_allclose(a, b, rtol=RTOL, err_msg=f)
    assert got.signs.shape == want.signs.shape and got.signs.dtype == torch.uint8
    assert (np.unpackbits(got.signs.numpy()) == np.unpackbits(want.signs)).mean() >= CODE_SHARE
    assert got.bits_per_vector == want.bits_per_vector
    carried = P.rabitq_from_numpy(want, device="cpu")
    ids = np.random.default_rng(1).integers(0, len(x), 3000)
    for q in queries:
        for sel in (ids, np.arange(len(x))):
            est = P.rabitq_estimate(carried, q, sel).numpy()
            ref = R.rabitq_estimate(want, q, sel)
            assert est.dtype == ref.dtype
            np.testing.assert_allclose(est, ref, rtol=RTOL)
    back = R.RaBitQ(**P.rabitq_to_numpy(got))
    assert np.array_equal(back.signs, got.signs.numpy())


def test_fit_pq_under_256_rows_and_twice(data):
    """200 rows: centroids drawn with replacement, duplicates leave clusters
    empty (they keep their value); a second fit gives the same bits."""
    x = data["unit"][0][:200]
    want = R.fit_pq(x, 8, iters=6, seed=5)
    got = P.fit_pq(x, 8, iters=6, seed=5, device="cpu")
    np.testing.assert_allclose(got.codebooks.numpy(), want.codebooks, rtol=CB_RTOL,
                               atol=CB_ATOL)
    check_codes(got.codes.numpy(), want.codes, want.codebooks, x)
    assert len(np.unique(want.codes[:, 0])) < 256            # empty clusters
    again = P.fit_pq(x, 8, iters=6, seed=5, device="cpu")
    assert torch.equal(again.codebooks, got.codebooks) and torch.equal(again.codes, got.codes)
    rq = [P.fit_rabitq(x, "l2", device="cpu") for _ in range(2)]
    for f in ("rotation", "center", "signs", "norms", "ip_unit"):
        assert torch.equal(getattr(rq[0], f), getattr(rq[1], f)), f


def test_np_sum_is_numpys_order():
    """Sums of every length up to 300 equal numpy's float32 ``sum(-1)``."""
    rng = np.random.default_rng(0)
    for n in list(range(1, 40)) + [64, 100, 128, 129, 200, 256, 300]:
        x = (rng.standard_normal((64, n)) * rng.uniform(0.1, 1e3, (64, 1))).astype(np.float32)
        assert np.array_equal(P.np_sum(torch.from_numpy(x)).numpy(), x.sum(-1)), n


def test_pack_bits_is_numpys():
    rng = np.random.default_rng(0)
    for d in (8, 13, 64, 128):
        bits = rng.random((50, d)) < 0.5
        packed = P.pack_bits(torch.from_numpy(bits))
        assert np.array_equal(packed.numpy(), np.packbits(bits.astype(np.uint8), axis=1))
        assert np.array_equal(P.unpack_bits(packed, d).numpy(), bits.astype(np.uint8))
