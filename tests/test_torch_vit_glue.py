"""The ViT block's glue between its GEMMs (``ops/cuda_vit_glue.py``, kernels
``vit_swiglu`` and ``vit_residual_ln`` of ``csrc/vit_glue.cu``) on the CPU:
the plain twins bit for bit against the block's ops as they were before the
kernels, ``_block`` and ``forward`` against the block as it was, in f32 and
bf16 for UNI and Virchow2; what the routes leave to the twins and what the
wrappers refuse, called alone or through the routes; the launches they make,
against a stand-in for the kernel library, per call and per block of each
config.  The kernels themselves are held against the twins on the card by
``chip_smoke.py`` (its ``vit_swiglu`` and ``vit_residual_ln`` rows)."""

import math

import pytest
import torch
import torch.nn.functional as F

from sequoia_tpu_torch import _build
from sequoia_tpu_torch.models import uni_vit as tuni
from sequoia_tpu_torch.ops import cuda_vit
from sequoia_tpu_torch.ops import cuda_vit_glue as glue
from tests.test_torch_vis_wgmma import fake_lib  # noqa: F401  (fixture)

DTYPES = pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
#: ragged row counts: one row, a prime, Virchow2's tokens of one image
ROWS = pytest.mark.parametrize("rows", [1, 37, 261])
#: the residual's width and LayerNorm eps: UNI's and Virchow2's
WIDTHS = pytest.mark.parametrize("d, eps", [(1024, 1e-5), (1280, 1e-6)], ids=["uni", "virchow2"])
#: Virchow2's gate: fc1's 6832 outputs, fc2's 3416 inputs
GATE_HIDDEN = 3416


def _randn(shape, dtype, seed, scale=2.0):
    g = torch.Generator().manual_seed(seed)
    return (scale * torch.randn(shape, generator=g)).to(dtype)


def _affine(d, dtype, seed):
    """gamma (LayerScale 0.1 and spread), LayerNorm scale and bias."""
    return (_randn((d,), dtype, seed, 0.1), (1 + _randn((d,), torch.float32, seed + 1, 0.2))
            .to(dtype), _randn((d,), dtype, seed + 2, 0.1))


# ---------------------------------------------------------------------------
# the plain twins against the block's ops before the kernels
# ---------------------------------------------------------------------------

@DTYPES
@ROWS
def test_swiglu_plain_is_the_gate_before(rows, dtype):
    h = _randn((rows, 2 * GATE_HIDDEN), dtype, rows)
    a, b = h.chunk(2, dim=-1)
    want = F.silu(a) * b
    for got in (glue.swiglu_plain(h), glue.swiglu(h), tuni._swiglu(h)):
        assert got.dtype == dtype and torch.equal(got, want)


@DTYPES
@ROWS
@WIDTHS
def test_residual_ln_plain_is_addcmul_then_layer_norm(rows, d, eps, dtype):
    x, out = _randn((rows, d), dtype, 3), _randn((rows, d), dtype, 4)
    gamma, scale, bias = _affine(d, dtype, 5)
    xs = torch.addcmul(x, out, gamma)
    y = F.layer_norm(xs, (d,), scale, bias, eps)
    for got_x, got_y in (glue.residual_ln_plain(x, out, gamma, scale, bias, eps),
                         glue.residual_ln(x, out, gamma, scale, bias, eps),
                         tuni._residual(x, out, gamma, (scale, bias), eps)):
        assert torch.equal(got_x, xs) and torch.equal(got_y, y)


# ---------------------------------------------------------------------------
# the block and the forward against the block as it was
# ---------------------------------------------------------------------------

def _block_before(cfg, x, bp):
    """``models/uni_vit._block`` before the glue kernels, line for line."""
    b, n, d = x.shape
    y = tuni._layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.ln_eps)
    qkv = tuni._linear(y, bp["w_qkv"], bp["b_qkv"]).reshape(b * n, 3 * d)
    out = cuda_vit.attention(qkv, b, n, cfg.heads)
    out = tuni._linear(out.reshape(b, n, d), bp["w_proj"], bp["b_proj"])
    x = torch.addcmul(x, out, bp["ls1"].to(out.dtype))
    y = tuni._layer_norm(x, bp["ln2_scale"], bp["ln2_bias"], cfg.ln_eps)
    y = tuni._linear(y, bp["w_fc1"], bp["b_fc1"])
    if cfg.mlp == "gelu":
        y = F.gelu(y)
    else:
        a, g = y.chunk(2, dim=-1)
        y = F.silu(a) * g
    y = tuni._linear(y, bp["w_fc2"], bp["b_fc2"])
    return torch.addcmul(x, y, bp["ls2"].to(y.dtype))


def _forward_before(cfg, params, images):
    """``models/uni_vit.forward`` before the glue kernels, line for line."""
    b, p, g = images.shape[0], cfg.patch_size, cfg.grid
    dt = tuni.compute_dtype(cfg.compute_dtype)
    x = images.to(dt).reshape(b, g, p, g, p, 3).permute(0, 1, 3, 2, 4, 5)
    x = tuni._linear(x.reshape(b, g * g, p * p * 3), params["patch_w"], params["patch_b"])
    prefix = [params["cls_token"].to(dt).expand(b, 1, cfg.dim)]
    if cfg.reg_tokens:
        prefix.append(params["reg_token"].to(dt).expand(b, cfg.reg_tokens, cfg.dim))
    x = torch.cat([*prefix, x], dim=1) + params["pos_emb"].to(dt)
    for i in range(cfg.depth):
        x = _block_before(cfg, x, {k: v[i] for k, v in params["blocks"].items()})
    if cfg.pool == "cls":
        return tuni._layer_norm(x[:, 0], params["norm_scale"], params["norm_bias"],
                                cfg.ln_eps).float()
    y = tuni._layer_norm(x, params["norm_scale"], params["norm_bias"], cfg.ln_eps).float()
    return torch.cat([y[:, 0], y[:, cfg.prefix:].mean(1)], dim=-1)


def _cfg(kind, dtype, depth=2, mlp_dim=None):
    cls = tuni.UniViTConfig if kind == "uni" else tuni.Virchow2Config
    return cls(img_size=28, patch_size=14, dim=160, depth=depth, heads=2,
               mlp_dim=mlp_dim or (320 if kind == "uni" else 854), compute_dtype=dtype)


def _model(cfg, seed=1):
    params = tuni.prepare(cfg, tuni.random_params(cfg, torch.Generator().manual_seed(seed),
                                                  layer_scale=0.1))
    images = torch.randn((2, 28, 28, 3), generator=torch.Generator().manual_seed(seed + 1))
    return params, images


@DTYPES
@pytest.mark.parametrize("kind", ["uni", "virchow2"])
def test_block_and_forward_are_the_bits_of_before(kind, dtype):
    cfg = _cfg(kind, dtype)
    params, images = _model(cfg)
    with torch.no_grad():
        assert torch.equal(tuni.forward(cfg, params, images),
                           _forward_before(cfg, params, images))
        x = _randn((2, cfg.tokens, cfg.dim), dtype, 9)
        bp = {k: v[0] for k, v in params["blocks"].items()}
        nxt = (params["norm_scale"], params["norm_bias"])
        y = tuni._layer_norm(x, bp["ln1_scale"], bp["ln1_bias"], cfg.ln_eps)
        got_x, got_y = tuni._block(cfg, x, y, bp, nxt)
        want_x = _block_before(cfg, x, bp)
        assert torch.equal(got_x, want_x)
        assert torch.equal(got_y, tuni._layer_norm(want_x, *nxt, cfg.ln_eps))


# ---------------------------------------------------------------------------
# the wrappers: what they refuse, what they launch
# ---------------------------------------------------------------------------

class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on the card, so that the routes take the
    kernels' wrappers (launched against the stand-in library); what an op
    makes of it is one too."""

    @property
    def is_cuda(self):
        return True


def _unaligned(shape):
    return torch.zeros(math.prod(shape) + 1, dtype=torch.bfloat16)[1:].view(shape)


def _bf(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _res(x=None, out=None, gamma=None, d=16):
    """vit_residual_ln's arguments, (4, d) bf16, one of them replaced."""
    x = _bf(4, d) if x is None else x
    return (x, _bf(*x.shape) if out is None else out, _bf(d) if gamma is None else gamma,
            _bf(d), _bf(d), 1e-6)


# what each wrapper refuses, each with the words of its error
REFUSED = {
    "swiglu_f32": ("vit_swiglu", lambda: (torch.zeros((4, 32)),), "bf16"),
    "swiglu_half_not_8": ("vit_swiglu", lambda: (_bf(4, 2 * 12),), "multiple of 8"),
    "swiglu_odd": ("vit_swiglu", lambda: (_bf(4, 33),), "2H"),
    "swiglu_empty": ("vit_swiglu", lambda: (_bf(0, 32),), "with rows"),
    "swiglu_strided": ("vit_swiglu", lambda: (_bf(32, 4).T,), "contiguous"),
    "swiglu_unaligned": ("vit_swiglu", lambda: (_unaligned((4, 32)),), "16-byte aligned"),
    "res_f32": ("vit_residual_ln", lambda: _res(x=torch.zeros((4, 16))), "bf16"),
    "res_gamma_f32": ("vit_residual_ln", lambda: _res(gamma=torch.zeros(16)), "bf16"),
    "res_width_12": ("vit_residual_ln", lambda: _res(d=12), "multiple of 8"),
    "res_too_wide": ("vit_residual_ln", lambda: _res(d=glue.MAX_LN_WIDTH + 8), "D <="),
    "res_shapes": ("vit_residual_ln", lambda: _res(out=_bf(3, 16)), "gamma, scale"),
    "res_gamma_shape": ("vit_residual_ln", lambda: _res(gamma=_bf(8)), "gamma, scale"),
    "res_strided": ("vit_residual_ln", lambda: _res(x=_bf(16, 4).T), "contiguous"),
    "res_unaligned": ("vit_residual_ln", lambda: _res(out=_unaligned((4, 16))),
                      "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(REFUSED))
def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib, case):  # noqa: F811
    name, make, words = REFUSED[case]
    with pytest.raises(ValueError, match=words):
        getattr(glue, name)(*make())
    assert fake_lib.calls == [] and _build.LAUNCHES[name] == 0


def test_takes_is_false_off_the_card():
    h, x = _bf(4, 32), _bf(4, 16)
    assert glue.takes_swiglu(h.as_subclass(_OnCard))
    assert glue.takes_residual_ln(x.as_subclass(_OnCard))
    assert not glue.takes_swiglu(h) and not glue.takes_residual_ln(x)


# what the routes leave to the plain twins on the card: dtype and widths the
# kernels do not compute
PLAIN_ON_CARD = {
    "swiglu_f32": (glue.takes_swiglu, lambda: torch.zeros((4, 32))),
    "swiglu_half_not_8": (glue.takes_swiglu, lambda: _bf(4, 2 * 12)),
    "swiglu_odd": (glue.takes_swiglu, lambda: _bf(4, 33)),
    "res_f32": (glue.takes_residual_ln, lambda: torch.zeros((4, 16))),
    "res_width_12": (glue.takes_residual_ln, lambda: _bf(4, 12)),
    "res_too_wide": (glue.takes_residual_ln, lambda: _bf(4, glue.MAX_LN_WIDTH + 8)),
}


@pytest.mark.parametrize("case", list(PLAIN_ON_CARD))
def test_route_leaves_other_types_and_widths_to_the_twin(case):
    takes, make = PLAIN_ON_CARD[case]
    assert not takes(make().as_subclass(_OnCard))


# what the routes hand to the wrappers on the card, which refuse it: layouts
ROUTE_REFUSED = {
    "swiglu_strided": (lambda t: glue.swiglu(t(_bf(32, 4).T)), "contiguous"),
    "swiglu_unaligned": (lambda t: glue.swiglu(t(_unaligned((4, 32)))), "16-byte aligned"),
    "res_strided": (lambda t: glue.residual_ln(*map(t, _res(x=_bf(16, 4).T)[:5]), 1e-6),
                    "contiguous"),
    "res_unaligned": (lambda t: glue.residual_ln(*map(t, _res(out=_unaligned((4, 16)))[:5]),
                                                 1e-6), "16-byte aligned"),
}


@pytest.mark.parametrize("case", list(ROUTE_REFUSED))
def test_route_raises_on_the_card_where_the_kernel_refuses(fake_lib, case):  # noqa: F811
    """A CUDA bf16 tensor of a width the kernel computes goes to the kernel's
    wrapper, which raises on its layout: no quiet plain route."""
    call, words = ROUTE_REFUSED[case]
    with pytest.raises(ValueError, match=words):
        call(lambda t: t.as_subclass(_OnCard))
    assert fake_lib.calls == []
    assert _build.LAUNCHES["vit_swiglu"] == _build.LAUNCHES["vit_residual_ln"] == 0


def test_cpu_tensors_run_the_plain_twins(fake_lib):  # noqa: F811
    h = _randn((37, 2 * 24), torch.bfloat16, 10)
    assert torch.equal(glue.vit_swiglu(h), glue.swiglu_plain(h))
    args = (_randn((37, 16), torch.bfloat16, 11), _randn((37, 16), torch.bfloat16, 12),
            *_affine(16, torch.bfloat16, 13), 1e-6)
    for got, want in zip(glue.vit_residual_ln(*args), glue.residual_ln_plain(*args)):
        assert torch.equal(got, want)
    assert fake_lib.calls == [] and _build.LAUNCHES["vit_swiglu"] == 0
    assert _build.LAUNCHES["vit_residual_ln"] == 0


@pytest.mark.parametrize("lead, hid", [((2, 261), GATE_HIDDEN), ((37,), 8)],
                         ids=["virchow2", "n37"])
def test_cuda_route_launches_the_gate_once(fake_lib, lead, hid):  # noqa: F811
    h = _bf(*lead, 2 * hid).as_subclass(_OnCard)
    out = glue.swiglu(h)
    assert out.shape == (*h.shape[:-1], hid) and out.dtype == torch.bfloat16
    [(name, args)] = fake_lib.calls
    assert name == "sq_vit_swiglu" and len(args) == len(_build._SIGNATURES[name])
    assert args[:4] == (h.data_ptr(), out.data_ptr(), h.numel() // (2 * hid), hid)
    assert _build.LAUNCHES["vit_swiglu"] == 1


@WIDTHS
def test_cuda_route_launches_the_residual_once(fake_lib, d, eps):  # noqa: F811
    x, out = _bf(2, 197, d).as_subclass(_OnCard), _bf(2, 197, d)
    gamma, scale, bias = _bf(d), _bf(d), _bf(d)
    xs, y = glue.residual_ln(x, out, gamma, scale, bias, eps)
    assert xs.shape == y.shape == x.shape and xs.data_ptr() != y.data_ptr()
    [(name, args)] = fake_lib.calls
    assert name == "sq_vit_residual_ln" and len(args) == len(_build._SIGNATURES[name])
    assert args[:7] == tuple(t.data_ptr() for t in (x, out, gamma, scale, bias, xs, y))
    assert args[7:9] == (2 * 197, d) and args[9] == pytest.approx(eps)
    assert _build.LAUNCHES["vit_residual_ln"] == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["uni", "virchow2"])
def test_launches_per_block(fake_lib, kind, dtype):  # noqa: F811
    """On a stand-in card a bf16 forward takes the kernels at every glue
    point: Virchow2 one gate and two residuals a block (the last block's
    with the final norm), UNI no gate and two residuals a block; f32
    launches none of them."""
    depth = 3
    # fc1 of 864: a gate half (432) that is a multiple of 8
    cfg = _cfg(kind, dtype, depth=depth, mlp_dim=None if kind == "uni" else 864)
    params, images = _model(cfg)
    with torch.no_grad():
        for _ in range(2):  # two batches
            tuni.forward(cfg, params, images.as_subclass(_OnCard))
    bf16 = dtype == torch.bfloat16
    gates = 2 * depth if bf16 and kind == "virchow2" else 0
    residuals = 2 * 2 * depth if bf16 else 0
    attention = 2 * depth if bf16 else 0
    assert _build.LAUNCHES["vit_swiglu"] == gates
    assert _build.LAUNCHES["vit_residual_ln"] == residuals
    assert _build.LAUNCHES["vit_attention"] == attention
    assert len(fake_lib.calls) == gates + residuals + attention
    if residuals:
        eps = [args[9] for name, args in fake_lib.calls if name == "sq_vit_residual_ln"]
        assert eps == [pytest.approx(cfg.ln_eps)] * residuals
