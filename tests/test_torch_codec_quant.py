"""The int8 boundary folded into the port's eq. 8 codec, on the CPU (plain
versions of the fused kernels), numpy inputs made from a seed:

- ``core.compression.encode_quantized_1d`` / ``decode_quantized_1d``
  against the reference's composition, ``quantize_boundary(encode_1d(...))``
  and ``decode_1d(dequantize_boundary(...))``, with the reference's codec
  carried across through the bridge;
- the plan rule (``kernels.lowrank.codec_quant_plan``): which kernels the
  compression functions call at ranks 96 / 384 / 512 / 640, f32 and bf16,
  operands aligned and not;
- the cluster split emulated on the CPU: partial maxima of each 64-column
  tile (the fused encode) or of each slice of the reduced axis
  (``kernels.quant.cols_plan``, the column quantizer), maxed, give the
  line's amax and so the plain quantizer's scales;
- the new wrappers route CPU tensors to their plain versions (no launch
  counted) and raise on other devices; the codec's activation-type copy.

Tolerances: in f32 the codes and scales equal the reference's bit for bit
(Z from f32 sums in another order has not moved a code at these seeds). In
bf16 both sides round Z once from f32 sums taken in another order, so Z
may differ by one bf16 ulp (the codec's stated tolerance); where it does,
a code may sit one step off and a row's f16 scale one f16 ulp off, and
codes and scales are held to that; rows whose Z is equal have equal codes
and scale.  x^ from equal codes: rtol = atol = 1e-5 (f32), one bf16 ulp
(bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compression as jcomp
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config, smoke_config
from repro_torch.core import compression as tcomp
from repro_torch.core.hardware import PROFILES
from repro_torch.kernels.lowrank import (
    codec_quant_plan,
    lowrank_decode_quant,
    lowrank_decode_quant_plain,
    lowrank_encode_quant,
    lowrank_encode_quant_plain,
    lowrank_project_plain,
)
from repro_torch.kernels.quant import cols_plan, quantize_rows_plain
from repro_torch.models.model import Model
from repro_torch.serving.endcloud import plan_tiers

# one intra-op thread per test worker: the suite runs several workers on a
# few shared cores, where a many-thread pool stalls on every tiny op
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return (a.float() if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def _case(B, S, d, r, seed):
    """The reference's codec (jax and bridged) and x [B, S, d] with an
    all-zero token and one whose Z is small enough that its f16 scale
    underflows to 0."""
    jp = jcomp.init_lowrank_1d(jax.random.PRNGKey(seed), d, r)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = np.random.default_rng(seed).standard_normal((B, S, d)).astype(np.float32) * 3
    x[0, 0] = 0
    x[0, 1] *= 1e-7
    return jp, tp, x


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,r", [(128, 96), (768, 384), (768, 512), (768, 640), (96, 20)])
def test_encode_quantized_equals_reference_composition(d, r, dtype):
    jdt, tdt = DTYPES[dtype]
    jp, tp, x = _case(2, 5, d, r, seed=r)
    jz = jcomp.encode_1d(jp, jnp.asarray(x).astype(jdt))
    jq, js = jcomp.quantize_boundary(jz)
    tq, ts = tcomp.encode_quantized_1d(tp, torch.from_numpy(x).to(tdt))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == (2, 5, r)
    assert ts.dtype == torch.float16 and tuple(ts.shape) == (2, 5, 1)
    assert float(ts[0, 0, 0]) == float(ts[0, 1, 0]) == 0.0  # the zero and tiny tokens
    jq, js, tq, ts = (_np(a) for a in (jq, js, tq, ts))
    if dtype == "float32":
        np.testing.assert_array_equal(tq, jq)
        np.testing.assert_array_equal(ts, js)
        return
    tz = _np(tcomp.encode_1d(tp, torch.from_numpy(x).to(tdt)))
    jz = _np(jz)
    np.testing.assert_allclose(tz, jz, rtol=2 ** -7, atol=0)  # one bf16 ulp
    same_rows = (tz == jz).all(axis=-1)
    np.testing.assert_array_equal(tq[same_rows], jq[same_rows])
    np.testing.assert_array_equal(ts[same_rows], js[same_rows])
    assert np.abs(tq.astype(np.int32) - jq.astype(np.int32)).max() <= 1
    np.testing.assert_allclose(ts.astype(np.float32), js.astype(np.float32), rtol=2 ** -10)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("d,r", [(128, 96), (768, 384), (768, 640), (96, 20)])
def test_decode_quantized_equals_reference_composition(d, r, dtype):
    """The same codes and scales through both sides' decode."""
    jdt, tdt = DTYPES[dtype]
    jp, tp, x = _case(2, 3, d, r, seed=r + 1)
    q, s = jcomp.quantize_boundary(jcomp.encode_1d(jp, jnp.asarray(x)))
    want = _np(jcomp.decode_1d(jp, jcomp.dequantize_boundary(q, s, jdt)))
    got = tcomp.decode_quantized_1d(tp, torch.from_numpy(np.array(q)),
                                    torch.from_numpy(np.array(s)), tdt)
    assert got.dtype == tdt and tuple(got.shape) == (2, 3, d)
    if dtype == "float32":
        np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(_np(got), want, rtol=2 ** -7, atol=2 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("r,plan", [(96, "fused"), (384, "fused"), (512, "fused"),
                                    (513, "composed"), (640, "composed"), (1, "fused")])
def test_codec_quant_plan(r, plan):
    """At most 8 column tiles of 64 (a portable cluster) take the fused
    forms; the plan reads the rank alone."""
    assert codec_quant_plan(r) == plan


def _recorder(monkeypatch):
    """Record which kernel wrappers ``core.compression`` calls."""
    calls = []
    for name in ("lowrank_encode_quant", "lowrank_decode_quant", "lowrank_encode",
                 "lowrank_decode", "quantize_rows", "dequantize_rows"):
        fn = getattr(tcomp, name)

        def rec(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tcomp, name, rec)
    return calls


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [96, 384, 512, 640])
def test_plan_rule_routes_the_compression_functions(r, dtype, aligned, monkeypatch):
    """The fused wrappers up to r = 512, the standalone pair beyond, in f32
    and bf16, with x at a 16-byte boundary or off it (a view one element
    in): the same codes and x^ either way."""
    d, T = 768, 6  # d >= r: the codec is a QR of a [d, r] draw
    g = torch.Generator().manual_seed(r)
    codec = tcomp.init_lowrank_1d(g, d, r)
    buf = torch.randn(T * d + 1, generator=g).to(dtype)
    x = (buf[:-1] if aligned else buf[1:]).view(T, d)
    calls = _recorder(monkeypatch)
    q, s = tcomp.encode_quantized_1d(codec, x)
    xh = tcomp.decode_quantized_1d(codec, q, s, dtype)
    fused = r <= 512
    assert calls == (["lowrank_encode_quant", "lowrank_decode_quant"] if fused else
                     ["lowrank_encode", "quantize_rows", "dequantize_rows", "lowrank_decode"])
    wq, ws = lowrank_encode_quant_plain(x, codec["enc"].to(dtype))
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert torch.equal(xh, lowrank_decode_quant_plain(wq, ws, codec["dec"].to(dtype)))


@pytest.mark.parametrize("r", [96, 100, 384, 512])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cluster_row_split_emulation(r, dtype):
    """The fused encode's epilogue on the CPU: Z rounded to its type, each
    64-column tile's partial row maxima, maxed over the cluster's tiles,
    equal the row amax, and give the plain quantizer's scales and codes."""
    g = torch.Generator().manual_seed(r)
    x = torch.randn(37, 128, generator=g).to(dtype)
    x[3] = 0
    enc = torch.randn(128, r, generator=g).to(dtype)
    z = lowrank_project_plain(x, enc).float()
    tiles = [z[:, c:c + 64].abs().amax(-1) for c in range(0, r, 64)]
    assert len(tiles) <= 8
    amax = torch.stack(tiles).amax(0)
    assert torch.equal(amax, z.abs().amax(-1))
    scale = torch.clamp_min(amax / amax.new_tensor(127.0), 1e-8).half()
    q = torch.nan_to_num(torch.round(z / scale.float()[:, None]).clamp(-127, 127), nan=0.0)
    wq, ws = lowrank_encode_quant_plain(x, enc)
    assert torch.equal(scale[:, None], ws) and torch.equal(q.to(torch.int8), wq)


@pytest.mark.parametrize("outer,n,inner,itemsize,want", [
    (1, 3072, 768, 4, (8, True)),    # one slab's wo, f32: 24 column tiles
    (1, 768, 3072, 4, (4, True)),    # one slab's wi: 96 tiles
    (3, 3072, 768, 4, (4, True)),    # the pool's initial fill
    (19, 3072, 768, 4, (4, True)),   # a whole store: the slice decides
    (19, 768, 3072, 4, (1, True)),
    (1, 8192, 5120, 4, (8, False)),  # llama4-scout's wo: no cluster holds it in shared memory
    (1, 3072, 768, 2, (8, True)),    # bf16: 64-column tiles
    (2, 37, 45, 4, (8, True)),
])
def test_cols_plan(outer, n, inner, itemsize, want):
    assert cols_plan(outer, n, inner, itemsize, sms=132) == want


@pytest.mark.parametrize("outer,n,inner", [(1, 3072, 96), (3, 200, 40), (2, 37, 45)])
def test_cluster_column_split_emulation(outer, n, inner):
    """The column quantizer on the CPU: each cluster block's slice of the
    reduced axis gives partial column maxima; maxed they equal the column
    amax, and so the plain quantizer's scales."""
    g = torch.Generator().manual_seed(n)
    x = torch.randn(outer, n, inner, generator=g)
    x[0, :, 1] = 0
    cluster, _ = cols_plan(outer, n, inner, 4, sms=132)
    rows = -(-n // cluster)
    parts = [x[:, i:i + rows].abs().amax(-2) for i in range(0, n, rows)]
    assert len(parts) <= cluster
    amax = torch.stack(parts).amax(0)
    _, scale = quantize_rows_plain(x, axis=-2)
    assert torch.equal(torch.clamp_min(amax / amax.new_tensor(127.0), 1e-8), scale[:, 0])


def test_fused_wrappers_route_by_device():
    """CPU tensors run the plain versions (no launch counted); other
    devices raise, as every wrapper of the port does."""
    g = torch.Generator().manual_seed(0)
    x, enc = torch.randn(4, 32, generator=g), torch.randn(32, 16, generator=g)
    dec = enc.T.contiguous()
    before = (lowrank_encode_quant.launches, lowrank_decode_quant.launches)
    q, s = lowrank_encode_quant(x, enc)
    xh = lowrank_decode_quant(q, s, dec)
    assert (lowrank_encode_quant.launches, lowrank_decode_quant.launches) == before
    wq, ws = lowrank_encode_quant_plain(x, enc)
    assert torch.equal(q, wq) and torch.equal(s, ws)
    assert torch.equal(xh, lowrank_decode_quant_plain(q, s, dec))
    with pytest.raises(ValueError, match="device"):
        lowrank_encode_quant(x.to("meta"), enc.to("meta"))
    with pytest.raises(ValueError, match="device"):
        lowrank_decode_quant(q.to("meta"), s.to("meta"), dec.to("meta"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tier_plan_keeps_the_codec_in_the_activation_type(dtype):
    """``plan_tiers`` casts the codec once: the products read that copy
    (no cast a call) and give what a cast a call gives."""
    cfg = smoke_config(get_config("switch-base")).replace(num_layers=4, dtype=dtype)
    tiers = plan_tiers(Model(cfg, device="cpu"), end_profile=PROFILES["jetson-orin"],
                       cloud_profile=PROFILES["a100"], compression_rank=16)
    codec, act = tiers.codec, cfg.torch_dtype
    assert codec["enc"].dtype == codec["dec"].dtype == torch.float32
    assert codec["enc_act"].dtype == codec["dec_act"].dtype == act
    assert torch.equal(codec["enc_act"], codec["enc"].to(act))
    assert tcomp._weight(codec, "enc", act) is codec["enc_act"]
    assert tcomp._weight(codec, "dec", act) is codec["dec_act"]
    x = torch.randn(3, cfg.d_model, generator=torch.Generator().manual_seed(1)).to(act)
    plain = {"enc": codec["enc"], "dec": codec["dec"]}
    assert torch.equal(tcomp.encode_1d(codec, x), tcomp.encode_1d(plain, x))
    z = tcomp.encode_1d(codec, x)
    assert torch.equal(tcomp.decode_1d(codec, z), tcomp.decode_1d(plain, z))
