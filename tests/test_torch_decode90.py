"""The decode attention at the cache depth of the shipped configs (T = 16),
against the JAX package, and the contract its card kernel checks before a
launch (`decode_attention._check`).

The same inputs, drawn with numpy from a seed, go through the JAX kernels in
interpret mode and through the port's wrappers, which take their plain
versions because the tensors lie on the CPU: one frame (K7) and the [prev,
cur] pair (K8), the unquantized cache and the int8 one, t_B spanning 0 and
T - frames, an int8 token whose amax is 0 (scale 1), q, k and v the column
thirds of one qkv tensor in K2's (B, S, 3C) and K3's (B, 2, S, 3C) layouts.
Tolerance: atol = rtol = 1e-4 in fp32 (the same sums in another order), as
tests/test_torch_decode_attention.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu1x.ops import decode_attention as jdec
from tpu1x_torch import kernels
from tpu1x_torch.ops import decode_attention as tdec

torch.set_num_threads(2)
TOL = dict(atol=1e-4, rtol=1e-4)
L, B, S, C, H, T = 2, 4, 32, 64, 2, 16


def rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(autouse=True)
def no_launches():
    """CPU tensors take the plain versions: no kernel is ever counted."""
    kernels.reset_launches()
    yield
    assert not any(kernels.LAUNCHES.values()), kernels.LAUNCHES


def caches(rng, int8, t_B, C_=C):
    """k and v caches (T, L, B, S, C) and, for int8, their (L, B, T, S)
    scales, quantized by the JAX package. One attended token of each cache
    is all zeros, so its amax is 0 and its scale 1."""
    kc, vc = rand(rng, T, L, B, S, C_), rand(rng, T, L, B, S, C_)
    b = int(np.argmax(t_B))
    kc[t_B[b] - 1, :, b, 3] = 0.0
    vc[0, :, b, 5] = 0.0
    if not int8:
        return (kc, vc), {}
    out, scales = [], {}
    for name, c in (("k", kc), ("v", vc)):
        q, sc = jdec.quantize_kv(jnp.asarray(c))
        out.append(np.asarray(q))
        scales[f"{name}_scale"] = np.asarray(jnp.transpose(sc, (1, 2, 0, 3)))
    assert scales["k_scale"][:, b, t_B[b] - 1, 3].tolist() == [1.0] * L
    assert scales["v_scale"][:, b, 0, 5].tolist() == [1.0] * L
    return tuple(out), scales


@pytest.mark.parametrize("layer,H_,C_", [pytest.param(0, H, C, id="0"),
                                         pytest.param(1, H, C, id="1"),
                                         pytest.param(1, 1, C, id="1-h64"),
                                         pytest.param(1, 1, 2 * C,
                                                      id="1-h128"),
                                         pytest.param(1, 6, 384,
                                                      id="1-C384"),
                                         pytest.param(1, 25, 1600,
                                                      id="1-C1600"),
                                         pytest.param(1, 48, 3072,
                                                      id="1-C3072"),
                                         pytest.param(1, 32, 4096,
                                                      id="1-C4096"),
                                         pytest.param(1, 2, 144,
                                                      id="1-h72")])
@pytest.mark.parametrize("int8", [False, True], ids=["plain-cache", "int8"])
@pytest.mark.parametrize("pair", [False, True], ids=["K7", "K8"])
def test_decode_attention_t16(pair, int8, layer, H_, C_):
    """K7's and K8's wrappers on the CPU against the JAX kernels in interpret
    mode, q, k, v read in place from one qkv tensor; the output written into
    the caller's `out` and the k/v copies into `kv_out` are the same. H_ = 1
    at C = 64 and 128: head_dim 64 and 128, the kernel's other head
    widths; 6 and 25 heads of 64 at C = 384 and 1600, GENIE_138M-C384's
    and -C1600's widths (not multiples of 256); 48 heads of 64 at C = 3072
    (GENIE_138M-C3072's) and 32 of 128 at 4096, past 2048 channels, where
    the card's items hold a group of whole heads; 2 heads of 72 at C = 144
    (head_dim 72)."""
    rng = np.random.default_rng(10 + 2 * pair + int8)
    frames = 2 if pair else 1
    t_B = np.array((T - frames, 0, 7, 3) if pair else (0, 5, 11, T - 1),
                   np.int32)
    (kc, vc), scales = caches(rng, int8, t_B, C_)
    qkv = rand(rng, B, frames, S, 3 * C_) if pair else rand(rng, B, S, 3 * C_)
    kw = dict(layer=layer, scale=0.25, num_heads=H_)
    if pair:
        q, k, v = (qkv[:, :, :, i * C_:(i + 1) * C_] for i in range(3))
        args = (q[:, 0], q[:, 1], kc, vc, k[:, 0], v[:, 0], k[:, 1], v[:, 1],
                t_B)
        jfn, tfn = (jdec.temporal_decode2_attention,
                    tdec.temporal_decode2_attention)
    else:
        q, k, v = (qkv[..., i * C_:(i + 1) * C_] for i in range(3))
        args = (q, kc, vc, k, v, t_B)
        jfn, tfn = (jdec.temporal_decode_attention,
                    tdec.temporal_decode_attention)
    want = jfn(*map(jnp.asarray, args), tile_s=16, interpret=True, **kw,
               **{n: jnp.asarray(s) for n, s in scales.items()})
    tq = t(qkv)
    thirds = tq.split(C_, dim=-1)
    views = ([x[:, f] for x in thirds for f in range(2)] if pair
             else list(thirds))
    assert not views[0].is_contiguous()
    if pair:  # q0, q1, k0, k1, v0, v1 -> the wrapper's order
        tq0, tq1, tk0, tk1, tv0, tv1 = views
        targs = (tq0, tq1, t(kc), t(vc), tk0, tv0, tk1, tv1, t(t_B))
    else:
        targs = (views[0], t(kc), t(vc), views[1], views[2], t(t_B))
    tkw = dict(kw, **{n: t(s) for n, s in scales.items()})
    got = tfn(*targs, **tkw)
    got = got if pair else (got,)
    want = want if pair else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    if not pair:  # a row with t = 0 attends its own key alone
        for b in np.nonzero(t_B == 0)[0]:
            np.testing.assert_allclose(got[0][b].numpy(), v[b], **TOL)
    out = torch.zeros(frames, B, S, C_)
    kv = torch.zeros(2, B, S, C_)
    into = tfn(*targs, out=tuple(out) if pair else out[0],
               kv_out=(kv[0], kv[1]), **tkw)
    into = into if pair else (into,)
    for f in range(frames):
        assert into[f].data_ptr() == out[f].data_ptr()
        assert torch.equal(out[f], got[f])
    k0, v0 = (targs[4], targs[5]) if pair else (targs[3], targs[4])
    assert torch.equal(kv[0], k0) and torch.equal(kv[1], v0)


def contract(frames=1, int8=False, C_=256, S_=8, T_=16, B_=2):
    """A call the kernel takes: q, k, v the column thirds of one (B, frames,
    S, 3C) bf16 tensor, a (T, 2, B, S, C) cache, layer 1, 32-channel heads.
    Returns the keyword arguments of `decode_attention._check`."""
    L_ = 2
    qkv = torch.zeros(B_, frames, S_, 3 * C_, dtype=torch.bfloat16)
    q, k, v = (x.unbind(1) for x in qkv.split(C_, dim=-1))
    dtype = torch.int8 if int8 else torch.bfloat16
    kc = torch.zeros(T_, L_, B_, S_, C_, dtype=dtype)
    scales = ((torch.ones(L_, B_, T_, S_), torch.ones(L_, B_, T_, S_))
              if int8 else (None, None))
    return dict(qs=q, ks=k, vs=v, k_cache=kc, v_cache=kc.clone(),
                t_B=torch.zeros(B_, dtype=torch.int32), layer=1,
                k_scale=scales[0], v_scale=scales[1], out=None, kv_out=None,
                num_heads=C_ // 32)


@pytest.mark.parametrize("frames", [1, 2])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("C_", [256, 512, 384, 1600])
def test_check_takes_the_qkv_thirds(frames, int8, C_):
    """The contract takes q, k, v as the column thirds of one qkv tensor
    (K2's and K3's layout, each frame's view at the same strides), at the
    shipped widths and at GENIE_138M-C384's and -C1600's, with either
    cache; it returns their strides."""
    kw = contract(frames, int8, C_)
    kw["out"] = tuple(torch.zeros(frames, 2, 8, C_,
                                  dtype=torch.bfloat16).unbind(0))
    strides = tdec._check(**kw)
    assert strides == [(frames * 8 * 3 * C_, 3 * C_)] * 3 + [(8 * C_, C_)]


@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("B_", [17, 300])
def test_check_takes_any_batch(B_, int8):
    """No batch size is refused: the launcher takes 256 rows b a launch, so
    a larger batch is several launches, each row's q, k, v, out, caches and
    scales 16-byte aligned as the first row's."""
    kw = contract(frames=2, int8=int8, S_=4, B_=B_)
    strides = tdec._check(**kw)
    assert strides == [(2 * 4 * 3 * 256, 3 * 256)] * 3


def misaligned(x, offset_bytes):
    """A contiguous copy of x whose data starts `offset_bytes` past a
    16-byte boundary."""
    n = x.numel() * x.element_size()
    raw = torch.zeros(n + 16, dtype=torch.uint8)
    start = (16 - raw.data_ptr() % 16) % 16 + offset_bytes
    return raw[start:start + n].view(x.dtype).view(x.shape)


def _refused(case):
    if case == "T = 33":
        return contract(T_=33)
    if case == "C = 320":
        return contract(C_=320)
    if case == "C > 2048":
        return contract(C_=2304)
    if case == "C > 4096":
        return contract(C_=4128)
    kw = contract(int8=case in ("one scale", "int8 S % 4", "scale alignment"))
    if case == "one scale":
        kw["v_scale"] = None
    elif case == "int8 S % 4":
        kw = contract(int8=True, S_=6)
    elif case == "layer":
        kw["layer"] = 2
    elif case == "fp32 q":
        kw["qs"] = tuple(x.float() for x in kw["qs"])
    elif case == "token stride % 8":
        qkv = torch.zeros(2, 8, 3 * 256 + 4, dtype=torch.bfloat16)
        kw["qs"] = (qkv[..., :256],)
    elif case == "frames' strides differ":
        kw = contract(frames=2)
        kw["qs"] = (kw["qs"][0], kw["qs"][1].contiguous())
    elif case == "view alignment":
        qkv = torch.zeros(2, 8, 3 * 256 + 8, dtype=torch.bfloat16)
        kw["qs"] = (qkv[..., 4:4 + 256],)
    elif case == "cache alignment":
        kw["k_cache"] = misaligned(kw["k_cache"], 8)
    elif case == "scale alignment":
        kw["k_scale"] = misaligned(kw["k_scale"], 4)
    elif case == "cache layout":
        kw["v_cache"] = kw["v_cache"].transpose(3, 4).contiguous().transpose(
            3, 4)
    return kw


@pytest.mark.parametrize("case,message", [
    ("T = 33", "T <= 32"),
    pytest.param("C = 320", None, id="C = 320-C % 256 == 0"),
    pytest.param("C > 2048", None, id="C > 2048-C <= 2048"),
    ("C > 4096", "C <= 4096"),
    ("one scale", "both cache scales or neither"),
    ("int8 S % 4", r"S % 4 == 0"),
    ("layer", "layer must be an int"),
    ("fp32 q", "must be bf16"),
    ("token stride % 8", r"must be \(8 i, 8 j, 1\)"),
    ("frames' strides differ", "the same for every frame"),
    ("view alignment", "16-byte aligned"),
    ("cache alignment", "k_cache must be 16-byte aligned"),
    ("scale alignment", "k_scale must be 16-byte aligned"),
    ("cache layout", "v_cache must be contiguous"),
])
def test_check_refuses(case, message):
    """Every shape, dtype, stride and alignment the kernel's bulk copies
    and vector loads do not take raises before a launch, for that reason:
    there is no fallback on the card. C = 320 (10 heads of 32), which the
    ring refused while its items' rows had to be whole warps at 4 tokens
    (C % 256 == 0, the case's id), is taken since the ring takes any
    width up to 2048, and C = 2304, which it refused while 2048 was its
    limit (the case's id), since past 2048 channels an item holds a group
    of whole heads, up to MAX_C = 4096 (message None: the call returns its
    strides)."""
    if message is None:
        C_ = 320 if case == "C = 320" else 2304
        assert tdec._check(**_refused(case)) == [(8 * 3 * C_, 3 * C_)] * 3
        return
    with pytest.raises(ValueError, match=message):
        tdec._check(**_refused(case))
