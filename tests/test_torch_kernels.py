"""The port's segment count-sort (K1) and rank-map (K2) against the JAX
package's Pallas kernels.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held bitwise against the JAX kernels run in interpret mode (float32), and
against ``jnp.sort`` / the XLA tie fill ``_rank_fill_unsort`` in float64.
The CUDA kernels themselves are checked against the plain versions in
``test_torch_cuda.py``, on the card.
"""

import numpy as np
import numpy.testing as npt
import pytest
import torch

import jax.numpy as jnp

from skdownscale_tpu.models.grouped import _rank_fill_unsort
from skdownscale_tpu.ops.pallas.rank_map_kernel import (
    count_sort_rows,
    count_sort_segments,
    rank_map_rows,
    rank_map_segments,
)
from skdownscale_tpu.ops.pallas.sort_kernel import _to_ordered_int as jax_keys

from skdownscale_tpu_torch.kernels import rank_map as K
from skdownscale_tpu_torch.models.grouped import apply_ranked_rows
from skdownscale_tpu_torch.ops.keys import from_ordered_int, to_ordered_int


def _adversarial(rng, rows, L, dtype=np.float32, neg_nan=True):
    """Rows with NaN (and -NaN), +-0, +-inf, heavy ties and an all-equal row."""
    x = rng.normal(0, 50, (rows, L)).astype(dtype)
    x[0, -min(5, L):] = np.inf
    x[1 % rows, : min(3, L)] = -np.inf
    x[2 % rows, L // 2] = np.nan
    x[3 % rows] = np.round(x[3 % rows] / 50) * 50  # heavy ties
    x[4 % rows, :] = 7.0  # all equal
    x[5 % rows, 0] = -0.0
    x[5 % rows, -1] = 0.0
    x[5 % rows, L // 2] = np.inf
    x[6 % rows, 1 % L] = np.nan  # +inf query in a segment that holds a NaN
    x[6 % rows, 0] = np.inf
    if neg_nan:
        x[7 % rows, L - 1] = -np.nan
    return x


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32 if a.dtype == np.float32 else np.uint64)


# ----------------------------------------------------------------------
# ordered keys
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_ordered_keys_roundtrip_and_order(rng, dtype):
    x = _adversarial(rng, 8, 16, dtype).reshape(-1)
    k = to_ordered_int(torch.from_numpy(x))
    assert k.dtype == (torch.int32 if dtype == np.float32 else torch.int64)
    back = from_ordered_int(k, k.dtype == torch.int32 and torch.float32 or torch.float64)
    npt.assert_array_equal(_bits(back.numpy()), _bits(x))
    if dtype == np.float32:
        npt.assert_array_equal(k.numpy(), np.asarray(jax_keys(jnp.asarray(x))))
    # total order: -NaN < -inf < ... < -0 < +0 < ... < +inf < +NaN
    special = np.array([-np.nan, -np.inf, -1.0, -0.0, 0.0, 1.0, np.inf, np.nan], dtype)
    ks = to_ordered_int(torch.from_numpy(special)).numpy()
    assert np.all(np.diff(ks) > 0)


# ----------------------------------------------------------------------
# K1: count-sort
# ----------------------------------------------------------------------


@pytest.mark.parametrize("B,G,L", [(64, 4, 40), (9, 3, 16), (5, 2, 8)])
def test_count_sort_segments_bitwise_vs_pallas(rng, B, G, L):
    x = _adversarial(rng, B * G, L).reshape(B, G * L)
    want = np.asarray(count_sort_segments(jnp.asarray(x), L=L, interpret=True))
    got = K.count_sort_segments(torch.from_numpy(x), L).numpy()
    npt.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("B,L", [(12, 40), (6, 8), (7, 7)])
def test_count_sort_rows_bitwise_vs_pallas(rng, B, L):
    x = _adversarial(rng, B, L)
    want = np.asarray(count_sort_rows(jnp.asarray(x), interpret=True))
    got = K.count_sort_segments(torch.from_numpy(x), L).numpy()  # G = 1
    npt.assert_array_equal(_bits(got), _bits(want))


def test_count_sort_float64_bitwise_vs_jnp_sort(rng):
    """float64 (int64 keys) against jnp.sort.  jnp.sort keeps -0/+0 in input
    order and puts every NaN last, so the rows hold +NaN and one sign of
    zero, where the two orders agree bitwise."""
    x = _adversarial(rng, 4 * 3, 40, np.float64, neg_nan=False)
    x[x == 0] = 0.0  # +0 only (the tie row rounds small negatives to -0)
    x = x.reshape(4, 3 * 40)
    want = np.asarray(jnp.sort(jnp.asarray(x.reshape(-1, 40)), axis=-1)).reshape(x.shape)
    got = K.count_sort_segments(torch.from_numpy(x), 40).numpy()
    npt.assert_array_equal(_bits(got), _bits(want))


# ----------------------------------------------------------------------
# K2: rank-map
# ----------------------------------------------------------------------


def _brute_rank_map(x, res, L):
    """The counting definition, in numpy float compares."""
    q = x.reshape(-1, L)
    r = res.reshape(-1, L)
    out = np.full_like(q, np.nan)
    for i in range(q.shape[0]):
        for t in range(L):
            c = int(np.sum(q[i] <= q[i, t]))
            if c > 0:
                out[i, t] = r[i, c - 1]
    return out.reshape(x.shape)


@pytest.mark.parametrize("B,G,L", [(64, 4, 40), (9, 2, 16), (5, 3, 8)])
def test_rank_map_segments_bitwise_vs_pallas(rng, B, G, L):
    x = _adversarial(rng, B * G, L).reshape(B, G * L)
    res = np.sort(rng.normal(0, 1, (B * G, L)).astype(np.float32), axis=1).reshape(B, G * L)
    want = np.asarray(rank_map_segments(jnp.asarray(x), jnp.asarray(res), L=L, interpret=True))
    got = K.rank_map_segments(torch.from_numpy(x), torch.from_numpy(res), L).numpy()
    npt.assert_array_equal(_bits(got), _bits(want))
    npt.assert_array_equal(_bits(got), _bits(_brute_rank_map(x, res, L)))


@pytest.mark.parametrize("B,L", [(12, 40), (7, 7)])
def test_rank_map_rows_bitwise_vs_pallas(rng, B, L):
    x = _adversarial(rng, B, L)
    res = np.sort(rng.normal(0, 1, (B, L)).astype(np.float32), axis=1)
    want = np.asarray(rank_map_rows(jnp.asarray(x), jnp.asarray(res), interpret=True))
    got = apply_ranked_rows(torch.from_numpy(res), torch.from_numpy(x)).numpy()  # K2, G = 1
    npt.assert_array_equal(_bits(got), _bits(want))


def test_rank_map_float64_vs_rank_fill_unsort(rng):
    """float64 against the JAX package's XLA path (rank sort + run-end tie
    fill + unsort), with NaN queries, ties, +-0 and +-inf."""
    B, L = 24, 40
    x = _adversarial(rng, B, L, np.float64, neg_nan=False)
    res = np.sort(rng.normal(0, 1, (B, L)), axis=1)
    import jax

    pos = jnp.broadcast_to(jnp.arange(L, dtype=jnp.int32), (B, L))
    sv, spos = jax.lax.sort((jnp.asarray(x), pos), num_keys=1, is_stable=True, dimension=1)
    region = jnp.ones((B, L), jnp.int32)
    want = np.asarray(_rank_fill_unsort(jnp.asarray(res), sv, spos, region))
    got = K.rank_map_segments(torch.from_numpy(x), torch.from_numpy(res), L).numpy()
    npt.assert_array_equal(np.isnan(got), np.isnan(want))
    npt.assert_array_equal(_bits(got[~np.isnan(got)]), _bits(want[~np.isnan(want)]))
    npt.assert_array_equal(_bits(got), _bits(_brute_rank_map(x, res, L)))


# ----------------------------------------------------------------------
# dispatch
# ----------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_version_without_counting(rng):
    x = torch.from_numpy(_adversarial(rng, 4, 40))
    before = dict(K.LAUNCHES)
    K.count_sort_segments(x, 40)
    K.rank_map_segments(x, x, 40)
    assert dict(K.LAUNCHES) == before


@pytest.mark.parametrize(
    "call",
    [
        lambda x: K.count_sort_segments(x, 7),  # 40 % 7 != 0
        lambda x: K.rank_map_segments(x, x[:, :20], 20),  # res shape mismatch
        lambda x: K.rank_map_segments(x.reshape(-1), x.reshape(-1), 40),  # not 2-D
    ],
)
def test_wrappers_reject_bad_shapes(rng, call):
    with pytest.raises(ValueError):
        call(torch.from_numpy(_adversarial(rng, 4, 40)))
