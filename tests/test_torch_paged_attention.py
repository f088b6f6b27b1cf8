"""The port's paged-attention module and KV quantization against the JAX
package.

The CUDA kernels (csrc/paged_attention.cu) cannot run on the CPU; what
runs here is the module's plain PyTorch version, held against the JAX
package's reference and its Pallas kernels in interpret mode on the same
numpy inputs, and the Python around the kernels (dispatch by device, the
path log, argument checks). chip_smoke.py holds the kernels against the
plain version on the card.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu import quant as jquant
from paddle_tpu.kernels import paged_attention as jpa
from paddle_tpu_torch import quant as tquant
from paddle_tpu_torch.kernels import paged_attention as tpa

# fp32 on both sides, sums in another order: a few ulps of O(1) outputs
TOL = dict(atol=2e-5, rtol=2e-5)
KV_DTYPES = {"int8": (jnp.int8, torch.int8),
             "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def _ragged_case(seed):
    """The layout of tests/test_kernels.py's ragged case: a full chunk, a
    decode single, a short chunk at ctx 0 and a decode single."""
    rng = np.random.default_rng(seed)
    b, cq, h, d, bs, n, m = 4, 4, 4, 8, 4, 16, 4
    q = rng.normal(size=(b, cq, h, d)).astype(np.float32)
    kp = rng.normal(size=(n, bs, h, d)).astype(np.float32)
    vp = rng.normal(size=(n, bs, h, d)).astype(np.float32)
    tbl = rng.integers(1, n, (b, m)).astype(np.int32)
    q_lens = np.asarray([4, 1, 2, 1], np.int32)
    ctx = np.asarray([5, 9, 0, 3], np.int32)
    return q, kp, vp, tbl, q_lens, ctx


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _real_rows(got, want, q_lens):
    for i, n in enumerate(q_lens):
        np.testing.assert_allclose(got[i, :n], np.asarray(want)[i, :n],
                                   **TOL)


def _need_fp8(kv):
    if kv == "fp8" and not (jquant.supports_fp8() and tquant.supports_fp8()):
        pytest.skip("float8_e4m3fn is not supported on both sides")


@pytest.mark.parametrize("seed", [0, 3, 7])
def test_ragged_plain_matches_reference_and_pallas(seed):
    case = _ragged_case(seed)
    got = tpa.ragged_paged_attention(*_t(*case)).numpy()
    ref = jpa.ragged_paged_attention_reference(*_j(*case))
    pal = jpa.ragged_paged_attention_pallas(*_j(*case), interpret=True)
    _real_rows(got, ref, case[4])
    _real_rows(got, pal, case[4])


def test_plain_version_follows_the_reference_on_masked_rows():
    """Rows past q_lens: the plain version, like attend_reference, gives the
    uniform average of the masked values; the kernels give 0."""
    case = _ragged_case(5)
    got = tpa.ragged_paged_attention_reference(*_t(*case)).numpy()
    ref = np.asarray(jpa.ragged_paged_attention_reference(*_j(*case)))
    np.testing.assert_allclose(got, ref, **TOL)
    pal = np.asarray(jpa.ragged_paged_attention_pallas(*_j(*case),
                                                       interpret=True))
    assert np.all(pal[1, 1:] == 0.0)


@pytest.mark.parametrize("seed", [1, 2])
def test_single_query_entry_matches_reference_and_pallas(seed):
    rng = np.random.default_rng(seed)
    b, h, d, n, bs, m = 3, 4, 16, 16, 4, 4
    q = rng.normal(size=(b, h, d)).astype(np.float32)
    kp = rng.normal(size=(n, bs, h, d)).astype(np.float32)
    vp = rng.normal(size=(n, bs, h, d)).astype(np.float32)
    tbl = rng.integers(1, n, (b, m)).astype(np.int32)
    ctx = np.asarray([5, 16, 1], np.int32)       # visible keys
    got = tpa.paged_attention(*_t(q, kp, vp, tbl, ctx)).numpy()
    np.testing.assert_array_equal(
        got, tpa.paged_attention_reference(*_t(q, kp, vp, tbl, ctx)).numpy())
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_attention_reference(*_j(q, kp, vp, tbl,
                                                           ctx))), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jpa.paged_attention_pallas(*_j(q, kp, vp, tbl, ctx),
                                                   interpret=True)), **TOL)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantize_kv_rows_bit_for_bit(kv):
    _need_fp8(kv)
    jdt, tdt = KV_DTYPES[kv]
    x = (np.random.default_rng(4).normal(size=(32, 4, 16)) * 3
         ).astype(np.float32)
    x[3, 1] = 0.0                                # an all-zero row: scale 1
    x[5, 2, :4] = [0.5, -1.5, 2.5, 127.0]       # halves round to even
    jq, js = jquant.quantize_kv_rows(jnp.asarray(x), jdt)
    tq, ts = tquant.quantize_kv_rows(torch.from_numpy(x), tdt)
    assert tq.dtype == tdt and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                  np.asarray(jq).view(np.uint8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[3, 1].item() == 1.0


def _quant_pools(kv, seed, n=16, bs=4, h=4, d=8):
    """fp32 K/V quantized by each package from one numpy draw."""
    jdt, tdt = KV_DTYPES[kv]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(2):
        x = rng.normal(size=(n, bs, h, d)).astype(np.float32)
        jq, js = jquant.quantize_kv_rows(jnp.asarray(x), jdt)
        tq, ts = tquant.quantize_kv_rows(torch.from_numpy(x), tdt)
        out.append(((jq, js), (tq, ts)))
    return out


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_pools_match_pallas_single_query(kv):
    """As tests/test_quantized_serving.py holds the Pallas kernel: int8 and
    fp8 pools with their scales, one query a row."""
    _need_fp8(kv)
    (jk, tk), (jv, tv) = _quant_pools(kv, 3)
    rng = np.random.default_rng(3)
    q = rng.normal(size=(3, 4, 8)).astype(np.float32)
    tbl = rng.integers(1, 16, size=(3, 4)).astype(np.int32)
    ctx = np.asarray([5, 9, 1], np.int32)
    pal = jpa.paged_attention_pallas(jnp.asarray(q), jk[0], jv[0],
                                     jnp.asarray(tbl), jnp.asarray(ctx),
                                     k_scales=jk[1], v_scales=jv[1],
                                     interpret=True)
    got = tpa.paged_attention(torch.from_numpy(q), tk[0], tv[0],
                              torch.from_numpy(tbl), torch.from_numpy(ctx),
                              k_scales=tk[1], v_scales=tv[1])
    np.testing.assert_allclose(got.numpy(), np.asarray(pal), **TOL)


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quantized_pools_match_pallas_ragged(kv):
    _need_fp8(kv)
    (jk, tk), (jv, tv) = _quant_pools(kv, 8)
    q, _, _, tbl, q_lens, ctx = _ragged_case(8)
    pal = jpa.ragged_paged_attention_pallas(
        jnp.asarray(q), jk[0], jv[0], *_j(tbl, q_lens, ctx),
        k_scales=jk[1], v_scales=jv[1], interpret=True)
    got = tpa.ragged_paged_attention(
        torch.from_numpy(q), tk[0], tv[0], *_t(tbl, q_lens, ctx),
        k_scales=tk[1], v_scales=tv[1]).numpy()
    _real_rows(got, pal, q_lens)


def _ragged_case_d256(seed):
    """_ragged_case's rows at head dim 256, the widest instance of the
    rebuilt kernel: a full chunk, a decode single, a short chunk at ctx 0
    and a decode single."""
    rng = np.random.default_rng(seed)
    b, cq, h, d, bs, n, m = 4, 4, 2, 256, 4, 16, 4
    q = rng.normal(size=(b, cq, h, d)).astype(np.float32)
    tbl = rng.integers(1, n, (b, m)).astype(np.int32)
    q_lens = np.asarray([4, 1, 2, 1], np.int32)
    ctx = np.asarray([5, 9, 0, 3], np.int32)
    return q, (n, bs, h, d), tbl, q_lens, ctx


@pytest.mark.parametrize("kv", ["fp32", "int8"])
def test_head_dim_256_matches_pallas(kv):
    """The plain version at D 256 over fp32 and int8 pools against
    ragged_paged_attention_pallas in interpret mode."""
    q, shape, tbl, q_lens, ctx = _ragged_case_d256(11)
    if kv == "fp32":
        rng = np.random.default_rng(12)
        kp, vp = (rng.normal(size=shape).astype(np.float32)
                  for _ in range(2))
        pal = jpa.ragged_paged_attention_pallas(*_j(q, kp, vp, tbl, q_lens,
                                                    ctx), interpret=True)
        got = tpa.ragged_paged_attention(*_t(q, kp, vp, tbl, q_lens, ctx))
    else:
        (jk, tk), (jv, tv) = _quant_pools(kv, 12, *shape)
        pal = jpa.ragged_paged_attention_pallas(
            jnp.asarray(q), jk[0], jv[0], *_j(tbl, q_lens, ctx),
            k_scales=jk[1], v_scales=jv[1], interpret=True)
        got = tpa.ragged_paged_attention(
            torch.from_numpy(q), tk[0], tv[0], *_t(tbl, q_lens, ctx),
            k_scales=tk[1], v_scales=tv[1])
    _real_rows(got.numpy(), pal, q_lens)


def test_kernel_checks_take_head_dim_256():
    # D 256 passes the head-dim check and stops only at the device check
    q, shape, tbl, q_lens, ctx = _ragged_case_d256(13)
    kp = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="CUDA"):
        tpa._check(*_t(q, kp, kp, tbl, q_lens, ctx), None, None)


def test_cpu_tensors_take_the_plain_version_and_log_it():
    before = (tpa.launches, tpa.launches_quant)
    tpa.reset_path_log()
    tpa.ragged_paged_attention(*_t(*_ragged_case(0)))
    q, kp, vp, tbl, _, ctx = _ragged_case(1)
    tpa.paged_attention(*_t(q[:, 0], kp, vp, tbl, ctx + 1))
    assert tpa.paths_taken() == ["plain", "plain"]
    assert (tpa.launches, tpa.launches_quant) == before


def test_a_call_that_needs_the_kernel_without_cuda_raises():
    case = _t(*_ragged_case(0))
    for i in (0, 1, 2):                          # head dim 8 -> 16
        case[i] = torch.nn.functional.pad(case[i], (0, 8))
    with pytest.raises(ValueError, match="CUDA"):
        tpa._launch(*case, 0.25)
    meta = [t.to("meta") for t in case]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tpa.ragged_paged_attention(*meta)


@pytest.mark.parametrize("fault", ["head_dim", "q_dtype", "scales_missing",
                                   "scales_on_fp32", "pool_dtype",
                                   "table_rows", "strided_q"])
def test_kernel_refuses_what_it_does_not_take(fault):
    q, kp, vp, tbl, q_lens, ctx = _t(*_ragged_case(0))
    q = torch.nn.functional.pad(q, (0, 8))       # D 16: a head dim it takes
    kp = torch.nn.functional.pad(kp, (0, 8))
    vp = torch.nn.functional.pad(vp, (0, 8))
    kw = {}
    if fault == "head_dim":
        q, kp, vp = q[..., :8].contiguous(), kp[..., :8].contiguous(), \
            vp[..., :8].contiguous()
    elif fault == "q_dtype":
        q = q.double()
    elif fault == "scales_missing":
        kp, vp = kp.to(torch.int8), vp.to(torch.int8)
    elif fault == "scales_on_fp32":
        kw = dict(k_scales=torch.ones(kp.shape[:3]),
                  v_scales=torch.ones(kp.shape[:3]))
    elif fault == "pool_dtype":
        kp, vp = kp.half(), vp.half()
        kw = dict(k_scales=torch.ones(kp.shape[:3]),
                  v_scales=torch.ones(kp.shape[:3]))
    elif fault == "table_rows":
        tbl = tbl[:2]
    elif fault == "strided_q":
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        tpa._check(q, kp, vp, tbl, q_lens, ctx, kw.get("k_scales"),
                   kw.get("v_scales"))


def test_grid_follows_the_pool_dtype():
    assert tpa._inv_grid(torch.int8) == 1.0 / 127.0
    assert tpa._inv_grid(torch.float8_e4m3fn) == 1.0 / 448.0
    with pytest.raises(ValueError):
        tquant.grid_for_dtype(torch.float32)
    assert tquant.storage_dtype("int8") == torch.int8
    with pytest.raises(ValueError):
        tquant.storage_dtype("int4")
