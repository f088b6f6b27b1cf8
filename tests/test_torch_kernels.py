"""The port's kernel modules against the JAX package's Pallas kernels.

The CUDA kernels cannot run on the CPU; what runs here is each module's
plain PyTorch version, held against the Pallas kernel in interpret mode on
the same numpy inputs, and the Python around the kernels (dispatch by
device, argument checks, the build's keying and its failure). The CUDA
kernels are held against these plain versions on the card by
chip_smoke.py.
"""
import ctypes
import pathlib
import re
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.kernels import flash_attention as jfa
from paddle_tpu.kernels import layer_norm as jln
from paddle_tpu_torch.kernels import _build
from paddle_tpu_torch.kernels import flash_attention as tfa
from paddle_tpu_torch.kernels import layer_norm as tln

# several test processes share the machine's cores: one intra-op thread
# each keeps torch from oversubscribing them
torch.set_num_threads(1)

# fp32 on both sides; the sums run in another order: a few ulps of the
# O(1) values compared
F32_TOL = dict(atol=2e-5, rtol=2e-5)


def _rand(shape, seed, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale + shift
            ).astype(np.float32)


# --------------------------------------------------------------------------
# layer norm
# --------------------------------------------------------------------------

@pytest.mark.parametrize("eps", [1e-5, 1e-12])
def test_layer_norm_reference_matches_pallas(eps):
    x = _rand((16, 128), 0, scale=3.0, shift=1.0)
    g, b = _rand((128,), 1), _rand((128,), 2)
    y_j, res = jln._fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(b), eps,
                        interpret=True)
    mean_j, rstd_j = np.asarray(res[2])[:, 0], np.asarray(res[3])[:, 0]
    y_t, mean_t, rstd_t = tln.layer_norm_reference(
        torch.from_numpy(x), torch.from_numpy(g), torch.from_numpy(b), eps)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **F32_TOL)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, **F32_TOL)
    np.testing.assert_allclose(rstd_t.numpy(), rstd_j, **F32_TOL)


def test_layer_norm_reference_bf16_matches_pallas():
    # bf16 in and out, fp32 inside: the outputs may differ by one bf16
    # rounding step (2^-8 relative) of values up to ~4
    x = _rand((16, 128), 3, scale=2.0)
    g, b = _rand((128,), 4), _rand((128,), 5)
    y_j, _ = jln._fwd(jnp.asarray(x, jnp.bfloat16), jnp.asarray(g),
                      jnp.asarray(b), 1e-5, interpret=True)
    y_t, _, _ = tln.layer_norm_reference(
        torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(g),
        torch.from_numpy(b), 1e-5)
    assert y_t.dtype == torch.bfloat16
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               atol=3e-2, rtol=1e-2)


def test_layer_norm_wrappers_on_cpu_use_the_plain_version():
    before = tln.launches
    x = torch.from_numpy(_rand((2, 5, 96), 6))
    g, b = torch.from_numpy(_rand((96,), 7)), torch.from_numpy(_rand((96,), 8))
    y = tln.layer_norm(x, g, b, 1e-5)
    y2, mean, var = tln.layer_norm_with_stats(x, g, b, 1e-5)
    assert tln.launches == before
    assert y.shape == x.shape and mean.shape == (10,) and var.shape == (10,)
    torch.testing.assert_close(y, y2)
    # the JAX with_stats contract: mean/var flattened over leading dims
    y_j, mean_j, var_j = jln.layer_norm_with_stats(
        jnp.asarray(x.numpy()), jnp.asarray(g.numpy()),
        jnp.asarray(b.numpy()), 1e-5)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), **F32_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), **F32_TOL)
    # var comes back through 1/rstd^2 - eps: relative error of a few ulps
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), atol=1e-5,
                               rtol=1e-4)


@pytest.mark.parametrize("case", ["dtype", "gamma_dtype", "too_wide",
                                  "gamma_shape", "strided"])
def test_layer_norm_kernel_checks_refuse_what_it_cannot_take(case):
    x = torch.zeros(4, 64)
    g, b = torch.ones(64), torch.zeros(64)
    if case == "dtype":
        x = x.double()
    elif case == "gamma_dtype":
        g, b = g.double(), b.double()
    elif case == "too_wide":
        f = tln.MAX_FEATURES + 1
        x, g, b = torch.zeros(2, f), torch.ones(f), torch.zeros(f)
    elif case == "gamma_shape":
        g = torch.ones(32)
    else:
        x = torch.zeros(64, 4).t()
    with pytest.raises((TypeError, ValueError)):
        tln._check(x, g, b)


def test_layer_norm_kernel_checks_accept_bert_shapes():
    for dt in (torch.float32, torch.bfloat16):
        tln._check(torch.zeros(8, 384, 768, dtype=dt), torch.ones(768),
                   torch.zeros(768))
    x = torch.zeros(3, 4096, dtype=torch.bfloat16)
    tln._check(x, torch.ones(4096, dtype=torch.bfloat16),
               torch.zeros(4096, dtype=torch.bfloat16))


@pytest.mark.parametrize("f,dtype,w16", [
    (8192, torch.float32, False), (8192, torch.bfloat16, True),
    (768, torch.float16, False), (65536, torch.float16, True)])
def test_layer_norm_kernel_checks_accept_wide_rows_and_fp16(f, dtype, w16):
    w_dtype = dtype if w16 else torch.float32
    tln._check(torch.zeros(2, f, dtype=dtype),
               torch.ones(f, dtype=w_dtype), torch.zeros(f, dtype=w_dtype))


def test_layer_norm_on_a_device_without_kernel_raises():
    x = torch.zeros(4, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tln.layer_norm(x, torch.ones(64, device="meta"),
                       torch.zeros(64, device="meta"))


# --------------------------------------------------------------------------
# flash attention
# --------------------------------------------------------------------------

def _qkv(b, h, sq, sk, d, seed):
    return (_rand((b, h, sq, d), seed), _rand((b, h, sk, d), seed + 1),
            _rand((b, h, sk, d), seed + 2))


def _padding_bias(b, s, seed):
    lens = np.random.RandomState(seed).randint(s // 4, s + 1, size=b)
    m = (np.arange(s)[None, :] < lens[:, None]).astype(np.float32)
    return ((1.0 - m)[:, None, None, :] *
            np.finfo(np.float32).min).astype(np.float32)


FLASH_CASES = {
    "plain": dict(sq=128, sk=128, bias=False, causal=False),
    "padding_bias": dict(sq=128, sk=128, bias=True, causal=False),
    "causal": dict(sq=128, sk=128, bias=False, causal=True),
    "causal_sq_gt_sk": dict(sq=256, sk=128, bias=False, causal=True),
    # head dim 256, which the card's kernels are held against these plain
    # versions at
    "d256_plain": dict(sq=128, sk=128, bias=False, causal=False, d=256),
    "d256_padding_bias": dict(sq=128, sk=128, bias=True, causal=False,
                              d=256),
    "d256_causal_sq_gt_sk": dict(sq=256, sk=128, bias=False, causal=True,
                                 d=256),
}


@pytest.mark.parametrize("name", sorted(FLASH_CASES))
def test_attention_reference_matches_pallas(name):
    c = FLASH_CASES[name]
    b, h, d = 2, 2, c.get("d", 64)
    q, k, v = _qkv(b, h, c["sq"], c["sk"], d, 10)
    bias = _padding_bias(b, c["sk"], 11) if c["bias"] else None
    scale = 1.0 / np.sqrt(d)
    o_j, lse_j = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          None if bias is None else jnp.asarray(bias),
                          None, None, c["causal"], scale, 128, 128,
                          True, 1.0)
    o_t, lse_t = tfa.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        None if bias is None else torch.from_numpy(bias), c["causal"], scale)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), **F32_TOL)
    if name.endswith("causal_sq_gt_sk"):
        # the leading rows see no key: o = 0 and lse = 0 in both
        empty = c["sq"] - c["sk"]
        assert np.all(o_t.numpy()[:, :, :empty] == 0.0)
        assert np.all(lse_t.numpy()[:, :, :empty] == 0.0)


def test_fully_masked_row_follows_the_jax_reference():
    # a row whose every key is bias-masked: the JAX attention_reference
    # gives the uniform average of v (its Pallas kernel gives 0; BERT never
    # builds such a row). The port's plain version follows the reference.
    b, h, s, d = 2, 1, 128, 64
    q, k, v = _qkv(b, h, s, s, d, 50)
    bias = np.zeros((b, 1, 1, s), np.float32)
    bias[1] = np.finfo(np.float32).min
    o_j = jfa.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(bias))
    o_t, _ = tfa.attention_reference(torch.from_numpy(q),
                                     torch.from_numpy(k),
                                     torch.from_numpy(v),
                                     torch.from_numpy(bias))
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_TOL)
    np.testing.assert_allclose(o_t.numpy()[1, 0, 0], v[1, 0].mean(0),
                               **F32_TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_public_flash_attention_matches_jax(causal):
    b, h, s, d = 2, 2, 128, 64
    q, k, v = _qkv(b, h, s, s, d, 20)
    bias = _padding_bias(b, s, 21)
    o_j = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              bias=jnp.asarray(bias), causal=causal)
    before = tfa.launches
    o_t = tfa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v),
                              bias=torch.from_numpy(bias), causal=causal)
    assert tfa.launches == before  # the CPU path launches nothing
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_TOL)


def test_attention_reference_keep_mask_matches_jax():
    b, h, s, d = 1, 2, 64, 64
    q, k, v = _qkv(b, h, s, s, d, 30)
    keep = (np.random.RandomState(31).rand(b, h, s, s) >= 0.1
            ).astype(np.float32)
    o_j = jfa.attention_reference(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), keep_mask=jnp.asarray(keep),
                                  keep_prob=0.9)
    o_t, _ = tfa.attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        keep_mask=torch.from_numpy(keep), keep_prob=0.9)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), **F32_TOL)


def test_cpu_dropout_draws_its_keep_mask_from_the_generator():
    # the generator gives the seed; the keep mask is the seed-mode Philox
    # pattern the CUDA kernels regenerate
    b, h, s, d = 1, 2, 32, 64
    q, k, v = (torch.from_numpy(t) for t in _qkv(b, h, s, s, d, 40))
    o1 = tfa.flash_attention(q, k, v, dropout_rate=0.2,
                             generator=torch.Generator().manual_seed(5))
    o2 = tfa.flash_attention(q, k, v, dropout_rate=0.2,
                             generator=torch.Generator().manual_seed(5))
    seed = tfa.draw_seed(torch.Generator().manual_seed(5))
    keep = tfa.philox_keep_mask(seed, b, h, s, s, 0.8)
    o_ref, _ = tfa.attention_reference(q, k, v, keep_mask=keep,
                                       keep_prob=0.8)
    torch.testing.assert_close(o1, o2)
    torch.testing.assert_close(o1, o_ref)


def test_flash_attention_off_the_cpu_raises_for_dropout():
    # dropout runs in the CUDA kernels now; a device with no kernel raises
    # for it as for everything else
    q = torch.zeros(1, 2, 16, 64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(q, q, q, dropout_rate=0.1)
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention(q, q, q)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "mixed_dtype",
                                  "kv_shape", "strided_d"])
def test_flash_kernel_checks_refuse_what_it_cannot_take(case):
    q = k = v = torch.zeros(1, 2, 16, 64)
    if case == "head_dim":
        q = k = v = torch.zeros(1, 2, 16, 32)
    elif case == "dtype":
        q = k = v = q.double()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "kv_shape":
        v = torch.zeros(1, 2, 15, 64)
    else:
        q = torch.zeros(1, 2, 64, 16).transpose(-1, -2)
    with pytest.raises((TypeError, ValueError)):
        tfa._check(q, k, v)


def test_flash_kernel_checks_accept_strided_projection_views():
    # the fused-QKV path hands the kernel transposed views of [B,S,3E]
    b, s, h, d = 2, 77, 12, 64
    qkv = torch.zeros(b, s, 3 * h * d, dtype=torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    tfa._check(q, k, v)
    assert q.stride() == (s * 3 * h * d, d, 3 * h * d, 1)


def _record_bwd_launches(monkeypatch):
    """Route _launch_bwd's CPU tensors to stand-in launches that record
    their C arguments (the kernels cannot run here)."""
    calls = []

    def kernel(which):
        def launch(*args):
            calls.append((which, args))
            return 0
        return launch
    monkeypatch.setattr(tfa, "bwd_kernel", kernel)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return calls


def _bwd_inputs(q, k, v):
    o, lse = tfa.attention_reference(q, k, v)
    do = torch.from_numpy(_rand(tuple(o.shape), 9)).to(q.dtype)
    return do, o, lse


def test_flash_backward_launches_aligned_projection_views_uncopied(
        monkeypatch):
    # the main path's layout: q, k, v strided views of one fused [B,S,3E]
    # projection, every row on 16 bytes
    calls = _record_bwd_launches(monkeypatch)
    b, s, h, d = 2, 77, 2, 64
    qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 8)).to(torch.bfloat16)
    q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
               for t in qkv.split(h * d, dim=-1))
    do, o, lse = _bwd_inputs(q, k, v)
    before = tfa.bwd_copies
    dq, dk, dv = tfa._launch_bwd(do, q, k, v, o, lse, None, False, 0.125,
                                 None, None, 1.0)
    assert tfa.bwd_copies == before
    assert [w for w, _ in calls] == ["dq", "dkv"]
    for _, args in calls:
        assert args[:5] == tuple(t.data_ptr() for t in (q, k, v, o, do))
        assert args[10:13] == tuple(t.data_ptr() for t in (dq, dk, dv))


@pytest.mark.parametrize("dtype,copied", [(torch.bfloat16, 3),
                                          (torch.float16, 3),
                                          (torch.float32, 0)])
def test_flash_backward_copies_misaligned_bf16_inputs_and_counts_them(
        monkeypatch, dtype, copied):
    # rows that start 2 (4) bytes past 16 and have an odd stride: the bf16
    # kernels' 16-byte copies cannot read them, the fp32 kernels can
    calls = _record_bwd_launches(monkeypatch)
    base = torch.from_numpy(_rand((3, 1, 2, 40, 65), 10)).to(dtype)
    q, k, v = (base[i, ..., 1:] for i in range(3))
    do, o, lse = _bwd_inputs(q, k, v)
    before = tfa.bwd_copies
    tfa._launch_bwd(do, q, k, v, o, lse, None, True, 0.125, None, None, 1.0)
    assert tfa.bwd_copies - before == copied
    assert [w for w, _ in calls] == ["dq", "dkv"]
    ptrs = calls[0][1][:3]
    if copied:
        assert all(p % 16 == 0 for p in ptrs)
        assert ptrs != tuple(t.data_ptr() for t in (q, k, v))
    else:
        assert ptrs == tuple(t.data_ptr() for t in (q, k, v))


def test_flash_backward_refuses_head_dim_96_without_a_launch(monkeypatch):
    calls = _record_bwd_launches(monkeypatch)
    q = k = v = torch.zeros(1, 2, 16, 96, dtype=torch.bfloat16)
    do = o = torch.zeros_like(q)
    lse = torch.zeros(1, 2, 16)
    with pytest.raises(ValueError, match="head dim 96"):
        tfa._launch_bwd(do, q, k, v, o, lse, None, False, 0.1, None, None,
                        1.0)
    assert calls == []


def _record_fwd_launches(monkeypatch):
    """Route _launch_fwd's CPU tensors to a stand-in launch that records
    its C arguments and the 20 strides they point to."""
    calls = []

    def launch(*args):
        strides = tuple((ctypes.c_longlong * 20).from_address(args[13]))
        calls.append((args, strides))
        return 0
    monkeypatch.setattr(tfa, "fwd_kernel", lambda: launch)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    return calls


def test_flash_forward_launches_aligned_projection_views_uncopied(
        monkeypatch):
    # the main path's layout: q, k, v strided views of one fused [B,S,3E]
    # projection, every row on 16 bytes, in either dtype
    calls = _record_fwd_launches(monkeypatch)
    b, s, h, d = 2, 77, 2, 64
    for dtype in (torch.bfloat16, torch.float32):
        qkv = torch.from_numpy(_rand((b, s, 3 * h * d), 8)).to(dtype)
        q, k, v = (t.reshape(b, s, h, d).transpose(1, 2)
                   for t in qkv.split(h * d, dim=-1))
        before = tfa.fwd_copies
        o, lse = tfa._launch_fwd(q, k, v, None, False, 0.125, None, None,
                                 1.0)
        assert tfa.fwd_copies == before
        args, strides = calls[-1]
        assert args[:3] == tuple(t.data_ptr() for t in (q, k, v))
        assert args[6:8] == (o.data_ptr(), lse.data_ptr())
        assert args[8:13] == (b, h, s, s, d)
        assert strides[:9] == q.stride()[:3] + k.stride()[:3] + \
            v.stride()[:3]
        # o is laid out [B, S, H, D]: the caller's transpose back is free
        assert strides[9:12] == (s * h * d, d, h * d) == o.stride()[:3]
    assert len(calls) == 2


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("layout", ["odd_row_stride", "offset_contiguous"])
def test_flash_forward_copies_misaligned_inputs_and_counts_them(
        monkeypatch, dtype, layout):
    # rows that start 2 (bf16) or 4 (fp32) bytes past 16 bytes, with an odd
    # row stride or packed contiguously: the kernels' 16-byte copies cannot
    # read them in either dtype, so each of q, k, v is copied to 16-byte
    # rows first and counted
    calls = _record_fwd_launches(monkeypatch)
    if layout == "odd_row_stride":
        base = torch.from_numpy(_rand((3, 1, 2, 40, 65), 10)).to(dtype)
        q, k, v = (base[i, ..., 1:] for i in range(3))
    else:
        flat = torch.from_numpy(_rand((3 * 2 * 40 * 64 + 1,), 10)).to(dtype)
        q, k, v = flat[1:].reshape(3, 1, 2, 40, 64).unbind(0)
        assert q.is_contiguous()
    assert all(t.data_ptr() % 16 != 0 for t in (q, k, v))
    before = tfa.fwd_copies
    tfa._launch_fwd(q, k, v, None, True, 0.125, None, None, 1.0)
    assert tfa.fwd_copies - before == 3
    args, strides = calls[0]
    per = 16 // q.element_size()
    assert all(p % 16 == 0 for p in args[:3])
    assert all(st % per == 0 for st in strides[:9])
    assert set(args[:3]).isdisjoint(t.data_ptr() for t in (q, k, v))


def test_flash_forward_refuses_head_dim_96_without_a_launch(monkeypatch):
    calls = _record_fwd_launches(monkeypatch)
    q = k = v = torch.zeros(1, 2, 16, 96, dtype=torch.bfloat16)
    before = tfa.fwd_copies
    with pytest.raises(ValueError, match="head dim 96"):
        tfa._launch_fwd(q, k, v, None, False, 0.1, None, None, 1.0)
    assert calls == [] and tfa.fwd_copies == before


# --------------------------------------------------------------------------
# the build
# --------------------------------------------------------------------------

def test_build_keys_the_library_on_the_source(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    first = _build.library_path("k")
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    assert _build.library_path("k") == first
    (src / "k.cu").write_text("// two\n")
    assert _build.library_path("k") != first


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()


def test_build_failure_raises_with_the_compiler_output(tmp_path,
                                                       monkeypatch):
    # a stand-in compiler that fails: no library, and an error that says why
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no such intrinsic' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// k\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="no such intrinsic"):
        _build.build(["k"])
    assert not _build.library_path("k").exists()


def test_every_kernel_source_is_in_the_package():
    replaces = {"layer_norm": ("paddle_tpu/kernels/layer_norm.py:_fwd_kernel",
                               "paddle_tpu/kernels/layer_norm.py:_bwd_kernel"),
                "flash_attention": (
                    "paddle_tpu/kernels/flash_attention.py:_fwd_kernel",
                    "_drop_keep_tile"),
                "flash_attention_bwd": (
                    "paddle_tpu/kernels/flash_attention.py:",
                    "_bwd_dq_kernel", "_bwd_dkv_kernel"),
                "paged_attention": (
                    "paddle_tpu/kernels/paged_attention.py",
                    "_ragged_kernel", "_ragged_kernel_quant")}
    assert set(replaces) == set(_build.KERNEL_SOURCES)
    for name in _build.KERNEL_SOURCES:
        text = (_build.CSRC_DIR / f"{name}.cu").read_text()
        assert "sm_90a" in text and 'extern "C"' in text
        # the note names the TPU kernels it replaces
        for what in replaces[name]:
            assert what in text, (name, what)
    # the bf16 kernels' wgmma and cp.async pieces exist once, in a header
    # that the forward and the backward both include
    header = "flash_wgmma.cuh"
    assert (_build.CSRC_DIR / header).exists()
    sources = {p.name: p.read_text() for p in _build.CSRC_DIR.iterdir()
               if p.suffix in (".cu", ".cuh")}
    for name in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert f'#include "{header}"' in sources[name], name
    for helper in ("cp_async16", "tile_async", "mnmajor_desc", "wgmma_rs",
                   "wgmma_ss_n64", "to_a_frags", "fast_exp2", "paired_bits"):
        defined = [n for n, text in sources.items()
                   if re.search(rf"__forceinline__ \w+ {helper}\(", text)]
        assert defined == [header], (helper, defined)


# --------------------------------------------------------------------------
# layer-norm backward
# --------------------------------------------------------------------------

def _ln_vjp_jax(x, g, b, dy, eps):
    """dx, dgamma, dbeta of the Pallas kernel (interpret mode) by jax.vjp."""
    import jax
    y, vjp = jax.vjp(lambda x_, g_, b_: jln._layer_norm(x_, g_, b_, eps, True),
                     x, g, b)
    return vjp(dy.astype(y.dtype))


@pytest.mark.parametrize("dtype,rows,f", [
    pytest.param("float32", 16, 128, id="float32"),
    pytest.param("bfloat16", 16, 128, id="bfloat16"),
    # each side of the backward's boundary between a warp a row and a
    # 512-thread CTA a row (bwd_instance)
    pytest.param("float32", 8, 1024, id="float32-1024"),
    pytest.param("bfloat16", 8, 1025, id="bfloat16-1025")])
def test_layer_norm_backward_matches_pallas(dtype, rows, f):
    # fp32: the same formula summed in another order, a few ulps of O(1)
    # values (dgamma/dbeta sum 8-16 rows). bf16 dx: both sides compute in
    # fp32 from identical bf16 inputs and round to bf16, so they may differ
    # by one bf16 step (2^-8 relative) of values up to ~4; dgamma and dbeta
    # stay fp32 (gamma's dtype) from identical bf16 products.
    eps = 1e-5
    x = _rand((rows, f), 60, scale=2.0, shift=0.5)
    g, b = _rand((f,), 61, 0.1, 1.0), _rand((f,), 62, 0.1)
    dy = _rand((rows, f), 63)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    dx_j, dg_j, db_j = _ln_vjp_jax(jnp.asarray(x, jdt), jnp.asarray(g),
                                   jnp.asarray(b), jnp.asarray(dy, jdt), eps)
    xt = torch.from_numpy(x).to(tdt)
    dyt = torch.from_numpy(dy).to(tdt)
    gt, bt = torch.from_numpy(g), torch.from_numpy(b)
    tol_dx = F32_TOL if dtype == "float32" else dict(atol=3e-2, rtol=1e-2)
    tol_w = F32_TOL if dtype == "float32" else dict(atol=1e-4, rtol=1e-4)

    _, mean, rstd = tln.layer_norm_reference(xt, gt, bt, eps)
    plain = tln.layer_norm_backward_reference(dyt, xt, gt, mean, rstd)
    xr = xt.clone().requires_grad_(True)
    gr, br = gt.clone().requires_grad_(True), bt.clone().requires_grad_(True)
    tln.layer_norm(xr, gr, br, eps).backward(dyt)
    for dx, dg, db in (plain, (xr.grad, gr.grad, br.grad)):
        assert dx.dtype == tdt and dg.dtype == db.dtype == torch.float32
        np.testing.assert_allclose(dx.float().numpy(),
                                   np.asarray(dx_j.astype(jnp.float32)),
                                   **tol_dx)
        np.testing.assert_allclose(dg.numpy(), np.asarray(dg_j), **tol_w)
        np.testing.assert_allclose(db.numpy(), np.asarray(db_j), **tol_w)


def test_layer_norm_with_stats_gradient_flows_through_y_only():
    x = torch.from_numpy(_rand((4, 96), 64)).requires_grad_(True)
    g = torch.ones(96, requires_grad=True)
    b = torch.zeros(96, requires_grad=True)
    y, mean, var = tln.layer_norm_with_stats(x, g, b)
    assert not mean.requires_grad and not var.requires_grad
    y.sum().backward()
    torch.testing.assert_close(b.grad, torch.full((96,), 4.0))


@pytest.mark.parametrize("rows,f,want", [
    (16384, 768, (132, 125)),  # BERT-base's train step: one CTA an SM
    (2048, 8192, (128, 16)),   # a 512-thread CTA a row, one an SM
    (7, 130, (1, 7)),          # fewer rows than a CTA's 24 warps
    (5, 4096, (5, 1)),
    (1001, 768, (126, 8)),     # 8 rows a CTA of 8 warps, 1 in the last
    (40, 65536, (14, 3)),      # clusters of 8: 16 at once
    (10 ** 6, 1, (132, 7576))])
def test_layer_norm_backward_grid_is_one_wave(rows, f, want):
    groups, per_group = tln.bwd_grid(rows, f)
    assert (groups, per_group) == want
    # every row in a group, no group without rows, and no more groups (of
    # K CTAs) than the H100's SMs hold at once
    assert (groups - 1) * per_group < rows <= groups * per_group
    kind, n, k = tln.bwd_instance(f)
    ctas_per_sm = 1 if kind == "warp" else tln.bwd_row_min_blocks(n)
    assert groups * k <= tln.SMS * ctas_per_sm
    if k > 1:
        assert groups <= tln.RESIDENT_CLUSTERS[k]


def test_layer_norm_backward_every_width_has_an_instance():
    warp_capacity = 32 * 4
    row_capacity = tln.BWD_ROW_THREADS * 4
    for f in range(1, tln.MAX_FEATURES + 1):
        kind, n, k = tln.bwd_instance(f)
        if f <= tln.BWD_WARP_MAX_FEATURES:
            assert kind == "warp" and k == 1 and n in tln.BWD_WARP_CHUNKS
            assert n * warp_capacity >= f
            smaller = [m for m in tln.BWD_WARP_CHUNKS if m < n]
            assert not smaller or smaller[-1] * warp_capacity < f
        else:
            assert kind == "row" and k in tln.BWD_CLUSTERS
            assert 1 <= n <= tln.BWD_ROW_MAX_CHUNKS
            # a CTA's slice fits its N chunks, the K slices cover the row,
            # and neither a smaller cluster nor fewer chunks would do
            s = (-(-f // k) + 3) // 4 * 4
            assert (n - 1) * row_capacity < s <= n * row_capacity
            assert k * s >= f
            assert k == 1 or \
                (k // 2) * row_capacity * tln.BWD_ROW_MAX_CHUNKS < f
    for f in (0, tln.MAX_FEATURES + 1):
        with pytest.raises(ValueError):
            tln.bwd_instance(f)


def test_layer_norm_backward_instances_mirror_the_cuda_source():
    src = (_build.CSRC_DIR / "layer_norm.cu").read_text()

    def const(name):  # an integer or a product of integers
        expr = re.search(rf"constexpr int {name} = ([\d *]+);", src).group(1)
        return int(np.prod([int(v) for v in expr.split("*")]))
    chunks = re.search(r"kWarpChunks\[\] = \{([^}]*)\}", src).group(1)
    assert tuple(int(v) for v in chunks.split(",")) == tln.BWD_WARP_CHUNKS
    assert const("kWarpMaxFeatures") == tln.BWD_WARP_MAX_FEATURES
    assert const("kRowThreads") == tln.BWD_ROW_THREADS
    assert const("kRowMaxChunks") == tln.BWD_ROW_MAX_CHUNKS
    assert const("kRowMaxCluster") == tln.BWD_CLUSTERS[-1]
    assert const("kMaxFeatures") == tln.MAX_FEATURES

    def ladder(fn):  # "n <= 1 ? 8 : n <= 2 ? 6 : ... : 2" as {n: blocks}
        body = re.search(rf"int {fn}\(int n\) \{{\s*return ([^;]+);",
                         src).group(1)
        steps = [(int(a), int(b))
                 for a, b in re.findall(r"n <= (\d+) \? (\d+)", body)]
        last = int(body.rsplit(":", 1)[1])
        return lambda n: next((b for a, b in steps if n <= a), last)
    warps, row = ladder("warp_cta_warps"), ladder("row_min_blocks")
    for n in tln.BWD_WARP_CHUNKS:
        assert warps(n) == tln.bwd_cta_warps(n)
    for n in range(1, tln.BWD_ROW_MAX_CHUNKS + 1):
        assert row(n) == tln.bwd_row_min_blocks(n)


def test_layer_norm_backward_scratch_stays_bounded():
    worst = 0
    for f in range(1, tln.MAX_FEATURES + 1, 7):
        groups, _ = tln.bwd_grid(10 ** 7, f)
        worst = max(worst, 2 * groups * f * 4)
    assert worst <= tln.MAX_BWD_SCRATCH_BYTES
    for rows, f in ((16384, 768), (2048, 8192), (3, 65536)):
        part = tln.bwd_scratch(rows, f, "cpu")
        assert part.dtype == torch.float32
        assert part.shape == (2, tln.bwd_grid(rows, f)[0], f)
        assert part.numel() * 4 <= tln.MAX_BWD_SCRATCH_BYTES


def test_layer_norm_backward_launch_passes_the_grid(monkeypatch):
    seen = []

    def fake(*args):
        seen.append(args)
        return 0
    monkeypatch.setattr(_build, "function", lambda *a: fake)
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    x = torch.zeros(300, 2050)
    before = tln.launches_bwd
    tln._launch_bwd(torch.zeros_like(x), x, torch.ones(2050),
                    torch.zeros(300), torch.ones(300))
    assert tln.launches_bwd == before + 1
    (args,) = seen
    assert args[9:12] == (300, 2050, tln.bwd_grid(300, 2050)[0])


def test_ln_bwd_probe_trace_patch_finds_its_anchors(tmp_path):
    # scripts/ln_bwd_probe.py trace stamps a copy of csrc/layer_norm.cu at
    # fixed lines; each must be in the source exactly once
    import importlib.util
    root = pathlib.Path(__file__).resolve().parent.parent
    spec = importlib.util.spec_from_file_location(
        "ln_bwd_probe", root / "scripts" / "ln_bwd_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    shutil.copytree(root / "paddle_tpu_torch", tmp_path / "paddle_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(root / "chip_smoke.py", tmp_path / "chip_smoke.py")
    copy = probe.make_trace_copy(tmp_path)
    src = (copy / "paddle_tpu_torch" / "csrc" / "layer_norm.cu").read_text()
    # the helper, then one stamp for each other entry
    assert src.count("gtime()") == len(probe.TRACE_PATCH)
    assert "pt_ln_trace" in src


# --------------------------------------------------------------------------
# flash-attention backward and dropout
# --------------------------------------------------------------------------

def _flash_vjp_jax(q, k, v, bias, keep, causal, scale, keep_prob, do):
    """(o, dq, dk, dv, dbias) of the Pallas kernels in interpret mode,
    through the JAX package's custom VJP (_flash), bias_grad=True."""
    import jax
    drop = None if keep is None else jnp.asarray(keep)
    args = [jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)]
    if bias is not None:
        args.append(jnp.asarray(bias))

    def f(q_, k_, v_, *b_):
        return jfa._flash(q_, k_, v_, b_[0] if b_ else None, drop, None,
                          causal, scale, 128, 128, True, keep_prob, True)
    o, vjp = jax.vjp(f, *args)
    grads = vjp(jnp.asarray(do))
    dbias = np.asarray(grads[3]) if bias is not None else None
    return (np.asarray(o), *(np.asarray(g) for g in grads[:3]), dbias)


FLASH_BWD_CASES = {
    "full_bias": dict(sq=128, sk=128, bias="full", causal=False, keep=False),
    "padding_bias": dict(sq=128, sk=128, bias="pad", causal=False,
                         keep=False),
    "causal": dict(sq=128, sk=128, bias=None, causal=True, keep=False),
    "causal_sq_gt_sk": dict(sq=256, sk=128, bias=None, causal=True,
                            keep=False),
    "keep_mask_bias": dict(sq=128, sk=128, bias="full", causal=False,
                           keep=True),
    "keep_mask_causal": dict(sq=128, sk=128, bias=None, causal=True,
                             keep=True),
    # head dim 256
    "d256_plain": dict(sq=128, sk=128, bias=None, causal=False, keep=False,
                       d=256),
    "d256_padding_bias": dict(sq=128, sk=128, bias="pad", causal=False,
                              keep=False, d=256),
    "d256_causal_sq_gt_sk": dict(sq=256, sk=128, bias=None, causal=True,
                                 keep=False, d=256),
    "d256_keep_mask_bias": dict(sq=128, sk=128, bias="full", causal=False,
                                keep=True, d=256),
}


@pytest.mark.parametrize("name", sorted(FLASH_BWD_CASES))
def test_flash_backward_matches_pallas(name):
    # fp32 on both sides; sums of 128 terms in another order: 1e-5 of the
    # O(1) gradients. The bias gradient sums ds over the broadcast dims.
    c = FLASH_BWD_CASES[name]
    b, h, d = 2, 2, c.get("d", 64)
    q, k, v = _qkv(b, h, c["sq"], c["sk"], d, 70)
    do = _rand((b, h, c["sq"], d), 71)
    bias = None
    if c["bias"] == "full":
        bias = _rand((b, 1, c["sq"], c["sk"]), 72)
    elif c["bias"] == "pad":
        bias = _padding_bias(b, c["sk"], 73)
    keep_prob = 0.9 if c["keep"] else 1.0
    keep = (np.random.RandomState(74).rand(b, h, c["sq"], c["sk"]) <
            keep_prob).astype(np.float32) if c["keep"] else None
    scale = 1.0 / np.sqrt(d)
    o_j, dq_j, dk_j, dv_j, db_j = _flash_vjp_jax(q, k, v, bias, keep,
                                                 c["causal"], scale,
                                                 keep_prob, do)
    tol = dict(atol=1e-5, rtol=1e-5)

    qt, kt, vt = (torch.from_numpy(t).requires_grad_(True) for t in (q, k, v))
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    kmt = None if keep is None else torch.from_numpy(keep).bool()
    o_t, lse_t = tfa.flash_attention_fwd(qt, kt, vt, bt, c["causal"], scale,
                                         keep_mask=kmt, keep_prob=keep_prob)
    o_t.backward(torch.from_numpy(do))
    np.testing.assert_allclose(o_t.detach().numpy(), o_j, **tol)
    for got, want in ((qt.grad, dq_j), (kt.grad, dk_j), (vt.grad, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    if bias is not None:
        np.testing.assert_allclose(bt.grad.numpy(), db_j, **tol)
    # the plain functions directly, on the same o and lse
    plain = tfa.attention_backward_reference(
        torch.from_numpy(do), *(torch.from_numpy(t) for t in (q, k, v)),
        o_t.detach(), lse_t, None if bias is None else torch.from_numpy(bias),
        c["causal"], scale, kmt, keep_prob)
    for got, want in zip(plain, (dq_j, dk_j, dv_j)):
        np.testing.assert_allclose(got.numpy(), want, **tol)
    if name.endswith("causal_sq_gt_sk"):
        # rows that see no key: o = 0, lse = 0 and no gradient
        empty = c["sq"] - c["sk"]
        assert np.all(qt.grad.numpy()[:, :, :empty] == 0.0)


def test_flash_bias_without_grad_gets_none_and_with_seed_raises():
    b, h, s, d = 1, 2, 32, 64
    q, k, v = (torch.from_numpy(t).requires_grad_(True)
               for t in _qkv(b, h, s, s, d, 80))
    bias = torch.from_numpy(_rand((b, 1, 1, s), 81)).requires_grad_(True)
    o, _ = tfa.flash_attention_fwd(q, k, v, bias.detach())
    o.sum().backward()
    assert bias.grad is None and q.grad is not None
    # the JAX package's rule: seed dropout cannot serve a bias gradient
    with pytest.raises(NotImplementedError, match="bias"):
        tfa.flash_attention_fwd(q, k, v, bias, seed=3, keep_prob=0.9)
    # a padding mask (detached) keeps seed mode
    tfa.flash_attention_fwd(q, k, v, bias.detach(), seed=3, keep_prob=0.9)


def test_philox_known_answers():
    # Random123's known-answer vectors for Philox4x32-10
    def run(ctr, key):
        words = tfa.philox4x32_10(
            tuple(torch.tensor([c], dtype=torch.int64) for c in ctr), key)
        return [int(w) for w in words]
    assert run((0, 0, 0, 0), (0, 0)) == [0x6627e8d5, 0xe169c58d, 0xbc57ac4c,
                                         0x9b00dbd8]
    m = 0xFFFFFFFF
    assert run((m, m, m, m), (m, m)) == [0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                                         0x6d5451fd]
    assert run((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
               (0xa4093822, 0x299f31d0)) == [0xd16cfe09, 0x94fdcceb,
                                            0x5001e420, 0x24126ea1]


def test_philox_keep_mask_rate_and_element_definition():
    seed, shape = 0x1234_5678_9ABC, (2, 3, 130, 129)
    keep = tfa.philox_keep_mask(seed, *shape, 0.9)
    assert keep.shape == shape and keep.dtype == torch.bool
    # 100k Bernoulli(0.1) draws: sd 1e-3; 0.005 is five of them
    assert abs(1.0 - keep.float().mean().item() - 0.1) < 0.005
    # every element is its own Philox word: a function of (seed, b, h, q, k)
    thresh = tfa.keep_threshold(0.9)
    rng = np.random.RandomState(90)
    for _ in range(50):
        b_, h_, q_, k_ = (int(rng.randint(n)) for n in shape)
        words = tfa.philox4x32_10(
            tuple(torch.tensor([c], dtype=torch.int64)
                  for c in (k_ >> 1, q_ >> 1, h_, b_)),
            (seed & 0xFFFFFFFF, seed >> 32))
        bit = int(words[(q_ & 1) * 2 + (k_ & 1)]) >= thresh
        assert bool(keep[b_, h_, q_, k_]) == bit


def test_philox_keep_mask_does_not_depend_on_tiling():
    # a block of the pattern drawn alone equals that block of a larger
    # draw: no tile or array size enters the pattern
    seed = 99
    full = tfa.philox_keep_mask(seed, 2, 2, 256, 192, 0.8)
    assert torch.equal(tfa.philox_keep_mask(seed, 2, 2, 64, 77, 0.8),
                       full[:, :, :64, :77])
    assert torch.equal(tfa.philox_keep_mask(seed, 1, 1, 256, 192, 0.8)[0],
                       full[0, :1])
    assert not torch.equal(tfa.philox_keep_mask(seed + 1, 2, 2, 256, 192,
                                                0.8), full)


def test_keep_threshold_follows_the_tpu_rule():
    assert tfa.keep_threshold(0.9) == int((1.0 - 0.9) * 2 ** 32)
    assert tfa.keep_threshold(1.0) == 0
    assert tfa.keep_threshold(0.0) == 2 ** 32 - 1


def test_seed_dropout_forward_and_backward_use_one_pattern():
    # seed mode on the CPU: the forward and the backward both regenerate
    # philox_keep_mask(seed); equal to mask mode with that mask
    b, h, s, d = 1, 2, 64, 64
    q, k, v = _qkv(b, h, s, s, d, 91)
    do = torch.from_numpy(_rand((b, h, s, d), 92))
    keep = tfa.philox_keep_mask(5, b, h, s, s, 0.85)
    grads = []
    for kw in (dict(seed=5), dict(keep_mask=keep)):
        ts = [torch.from_numpy(t).requires_grad_(True) for t in (q, k, v)]
        o, _ = tfa.flash_attention_fwd(*ts, keep_prob=0.85, **kw)
        o.backward(do)
        grads.append([o.detach()] + [t.grad for t in ts])
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)
