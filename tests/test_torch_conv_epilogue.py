"""PyTorch port: the VGG SuperPoint's convolution epilogue
(`ops/kernels/conv_epilogue.py`) on the CPU.

- The plain epilogue is the three passes the VGG ran after each
  convolution (the bias rounded to bf16 and added, `torch.relu`,
  `F.max_pool2d(x, 2, 2)`, then float32 for the heads), bit for bit, over
  every combination of its switches and even and odd maps.
- `VGGSuperPoint.features` on the CPU returns, bit for bit, what the
  forward written as those passes returns (`_features_passes`), with and
  without descriptors, and under autograd its gradients are that forward's
  too: training and the CPU take the plain passes.
- Which convolutions end in the kernel is decided by what their input
  shows (`VGGSuperPoint._fused`), and the wrapper refuses what the kernel
  does not take before it loads anything.

The kernel itself runs on the card (`tests/test_torch_cuda_kernels.py`).
This file imports neither JAX nor the JAX package.
"""

import itertools
import types

import pytest
import torch
import torch.nn.functional as F

from feature_point_cnn_tpu_torch.config import SuperPointConfig
from feature_point_cnn_tpu_torch.models import vgg_superpoint
from feature_point_cnn_tpu_torch.models.vgg_superpoint import ENCODER_DIMS, VGGSuperPoint
from feature_point_cnn_tpu_torch.ops import kernels
from feature_point_cnn_tpu_torch.ops.kernels import conv_epilogue as ep
from feature_point_cnn_tpu_torch.utils import profiling

CFG = SuperPointConfig(image_channels=1, descriptor_dim=256)


def _features_passes(model, image, enable_descriptor=True):
    """`VGGSuperPoint.features` written as each convolution with its bias
    and the three passes after it: the CPU's reference."""
    x = image.permute(0, 3, 1, 2).to(model.compute_dtype)
    last = len(ENCODER_DIMS) - 1
    for i in range(len(ENCODER_DIMS)):
        x = torch.relu(getattr(model, f"encoder_conv{i}_a")(x))
        x = torch.relu(getattr(model, f"encoder_conv{i}_b")(x))
        if i != last:
            x = F.max_pool2d(x, 2, 2)
    point = torch.relu(model.detector_conv_a(x))
    logits = model.detector_conv_b(point).float().permute(0, 2, 3, 1)
    if not enable_descriptor:
        b, hc, wc, _ = logits.shape
        return logits, logits.new_zeros((b, hc, wc, model.config.descriptor_dim))
    desc = torch.relu(model.descriptor_conv_a(x))
    desc = model.descriptor_conv_b(desc).float().permute(0, 2, 3, 1)
    norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
    return logits, desc / norm.clamp_min(1e-12)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits, so that NaNs compare equal to themselves."""
    return t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32)


def _conv_output(b, c, h, w, seed=0):
    """A channels-last bf16 'convolution output' with the values an
    epilogue must keep apart: NaN, infinities, signed zeros, ties of the
    bias add's rounding and magnitudes far apart."""
    g = torch.Generator().manual_seed(seed)
    y = (torch.randn((b, c, h, w), generator=g) * 3).to(torch.bfloat16)
    flat = y.view(-1)
    picks = torch.randperm(flat.numel(), generator=g)[:24]
    special = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0, 0.0, 1e30,
                            -1e30, 2 ** -130] * 3, dtype=torch.bfloat16)
    flat[picks] = special
    bias = torch.randn((c,), generator=g) * 0.5
    bias[0] = float("nan") if c > 3 else bias[0]
    return y.contiguous(memory_format=torch.channels_last), bias


@pytest.mark.parametrize("hw", [(6, 8), (7, 9)], ids=["even", "odd"])
@pytest.mark.parametrize("relu,pool,out_float32", list(itertools.product((True, False),
                                                                        repeat=3)))
def test_plain_epilogue_is_the_three_passes(relu, pool, out_float32, hw):
    y, bias = _conv_output(2, 16, *hw)
    want = y + bias.to(torch.bfloat16)[None, :, None, None]
    if relu:
        want = torch.relu(want)
    if pool:
        want = F.max_pool2d(want, 2, 2)
    if out_float32:
        want = want.float()
    got = ep.conv_epilogue(y, bias, relu, pool, out_float32)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want))
    if pool:
        assert got.shape[2:] == (hw[0] // 2, hw[1] // 2)


def _model(dtype, seed=0):
    model = VGGSuperPoint(CFG.replace(compute_dtype=dtype),
                          generator=torch.Generator().manual_seed(seed)).eval()
    with torch.no_grad():     # nonzero biases, so that the bias add shows
        for m in model.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.bias.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(seed + 1))
    return model


def _image(b=2, h=24, w=32, seed=3):
    return torch.rand((b, h, w, 1), generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("enable_descriptor", [True, False], ids=["desc", "no_desc"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cpu_features_are_the_plain_passes(dtype, enable_descriptor):
    model, image = _model(dtype), _image()
    with torch.no_grad():
        got = model.features(image, enable_descriptor)
        want = _features_passes(model, image, enable_descriptor)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.float32 and g.shape == w.shape
        assert torch.equal(g, w)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_training_gradients_are_the_plain_passes(dtype):
    """Under autograd the forward's gradients are those of the plain passes,
    bit for bit: training takes them."""
    model, image = _model(dtype), _image(seed=5)
    g = torch.Generator().manual_seed(7)
    weights = None
    grads = []
    for fn in (model.features, lambda x: _features_passes(model, x)):
        model.zero_grad(set_to_none=True)
        logits, desc = fn(image)
        if weights is None:
            weights = (torch.randn(logits.shape, generator=g), torch.randn(desc.shape, generator=g))
        ((logits * weights[0]).sum() + (desc * weights[1]).sum()).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    assert grads[0].keys() == grads[1].keys() and len(grads[0]) == 24
    for name, grad in grads[0].items():
        assert torch.equal(grad, grads[1][name]), name


def test_cpu_forward_never_loads_the_kernel(monkeypatch):
    """On the CPU the epilogue is the plain passes: no library is loaded and
    ``kernel.conv_epilogue`` stays where it was."""
    def refuse(name, signatures):
        raise AssertionError(f"{name} loaded on the CPU")

    monkeypatch.setattr(ep, "load_library", refuse)
    libs, before = dict(kernels._libs), profiling.counters()
    with torch.inference_mode():
        _model("bfloat16")(_image(1))
    assert "kernel.conv_epilogue" not in profiling.counted_since(before)
    assert kernels._libs == libs


class _Input(types.SimpleNamespace):
    """What `VGGSuperPoint._fused` reads of an input: a CUDA tensor's
    answers, without a card."""


# (input on the card, its dtype, grad mode on, parameters need grad, input
# needs grad, inside a width group, under torch.export) -> fused
RULE = {
    "serving": ((True, torch.bfloat16, False, True, False, False, False), True),
    "grad_on_frozen": ((True, torch.bfloat16, True, False, False, False, False), True),
    "training": ((True, torch.bfloat16, True, True, False, False, False), False),
    "input_needs_grad": ((True, torch.bfloat16, True, False, True, False, False), False),
    "float32": ((True, torch.float32, False, True, False, False, False), False),
    "cpu": ((False, torch.bfloat16, False, True, False, False, False), False),
    "width_group": ((True, torch.bfloat16, False, True, False, True, False), False),
    "exporting": ((True, torch.bfloat16, False, True, False, False, True), False),
}


@pytest.mark.parametrize("case", sorted(RULE))
def test_the_kernel_is_chosen_by_what_the_input_shows(monkeypatch, case):
    (cuda, dtype, grad, params_grad, input_grad, group, exporting), fused = RULE[case]
    conv = _model("bfloat16").encoder_conv1_a.requires_grad_(params_grad)
    x = _Input(is_cuda=cuda, dtype=dtype, requires_grad=input_grad)
    if group:
        monkeypatch.setattr(vgg_superpoint.spatial, "group", lambda: object())
    if exporting:
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    with torch.set_grad_enabled(grad):
        assert VGGSuperPoint._fused(x, conv) is fused


@pytest.mark.parametrize("case", ["float32", "nchw", "pool_c12", "bias_shape",
                                  "grad", "channels"])
def test_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, case):
    """The checks run before the library is loaded."""
    def refuse(name, signatures):
        raise AssertionError("loaded before the checks")

    monkeypatch.setattr(ep, "load_library", refuse)
    c = {"pool_c12": 12, "channels": ep.MAX_CHANNELS + 8}.get(case, 16)
    y, bias = _conv_output(1, c, 4, 4)
    if case == "float32":
        y = y.float()
    if case == "nchw":
        y = y.contiguous()
    if case == "bias_shape":
        bias = bias[:-1]
    if case == "grad":
        bias.requires_grad_(True)
    with pytest.raises(ValueError):
        ep._launch(y, bias, True, case == "pool_c12", False)
