"""Which arithmetic eval BatchNorm runs on the card, and whether a compiled
program reproduces it: the evidence behind `models/blocks.py::BatchNorm2d.
_exported_eval`, the form an exported frame program carries.

1. PyTorch's eager CUDA BatchNorm on bf16 channels-last activations
   (``batch_norm_transform_input_channels_last_kernel``) against emulated
   candidates, each rounded to bf16: the order of the products (``w * (x -
   mean) * invstd + b``, or ``(x - mean) * invstd * w + b`` as Inductor
   decomposes BatchNorm), with and without a fused last multiply-add, and
   ``invstd`` from float32 or float64.  Float64 emulates float32 roundings
   exactly, so a candidate with no mismatch is the kernel's arithmetic.
2. ``torch.compile`` (with `wrapper.py::INDUCTOR_CONFIGS`, as the packages)
   of Inductor's own BatchNorm, of the kernel's order written out with
   ``*`` and ``+`` (Inductor fuses no multiply-add when it emulates
   precision casts), and of `_exported_eval` (``torch.addcmul``, which
   Inductor lowers to a fused multiply-add): mismatches against eager.
3. The released model at 480x640, bf16: the eager forward, and compiled
   with Inductor's BatchNorm and with `_exported_eval`; logits that differ
   from eager, and the distance of each from the float32 forward (TF32
   off) as the float32 witness.

Run on a CUDA card: ``python3 probe_torch_batchnorm.py``; it prints one
JSON line a part and the card's name and power limit.
"""

import json
import sys

import torch
import torch.nn.functional as F

from chip_smoke import H, W, card_line, serving_frames


def emulated(x, w, b, m, v, eps) -> dict:
    """Candidates for the kernel's arithmetic, float32 roundings emulated
    in float64, each as bf16."""
    f32 = lambda t: t.float().double()
    c = (1, -1, 1, 1)
    inv = {"invstd_f32": torch.rsqrt(v + eps), "invstd_f64": torch.rsqrt(v.double() + eps)}
    x, w, b, m = x.double(), w.double().view(c), b.double().view(c), m.double().view(c)
    out = {}
    for ik, iv in inv.items():
        iv = iv.float().double().view(c)
        d = f32(x - m)
        t = f32(w * d)                      # the kernel's order
        out[f"w(x-m)*invstd+b fma {ik}"] = t * iv + b
        out[f"w(x-m)*invstd+b unfused {ik}"] = f32(t * iv) + b
        t = f32(d * iv)                     # Inductor's decomposition
        out[f"(x-m)*invstd*w+b fma {ik}"] = t * w + b
        out[f"(x-m)*invstd*w+b unfused {ik}"] = f32(t * w) + b
    return {k: y.to(torch.bfloat16) for k, y in out.items()}


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_torch_batchnorm: no CUDA device is available", file=sys.stderr)
        return 1
    import torch._inductor.config as inductor_config

    from feature_point_cnn_tpu_torch.config import SuperPointConfig
    from feature_point_cnn_tpu_torch.inference.wrapper import (
        INDUCTOR_CONFIGS,
        SuperPointFrontend,
    )
    from feature_point_cnn_tpu_torch.models.blocks import BatchNorm2d
    from feature_point_cnn_tpu_torch.ops.detection import decode_prob_map
    from feature_point_cnn_tpu_torch.utils.weights import released_path

    for k, v in INDUCTOR_CONFIGS.items():
        setattr(inductor_config, k, v)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # 1-2: one BatchNorm on (4, 64, 120, 160) bf16 channels-last activations
    g = torch.Generator().manual_seed(0)
    bn = BatchNorm2d(64).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.rand(64, generator=g) * 2 + 0.1)
        bn.bias.copy_(torch.randn(64, generator=g))
        bn.running_mean.copy_(torch.randn(64, generator=g))
        bn.running_var.copy_(torch.rand(64, generator=g) * 4 + 1e-3)
    bn = bn.cuda()
    x = (torch.randn(4, 64, 120, 160, generator=g) * 3).to(torch.bfloat16).cuda()
    x = x.contiguous(memory_format=torch.channels_last)
    args = (bn.weight, bn.bias, bn.running_mean, bn.running_var, bn.eps)
    with torch.no_grad():
        eager = bn(x)
        part1 = {k: int((y != eager).sum()) for k, y in emulated(x, *args).items()}
    print(json.dumps({"emulated_vs_eager_mismatches": part1, "elements": eager.numel()}))

    c = (1, -1, 1, 1)
    forms = {
        "inductor_batchnorm": lambda t: F.batch_norm(t, bn.running_mean, bn.running_var,
                                                     bn.weight, bn.bias, False, 0.0, bn.eps),
        "kernel_order_unfused": lambda t: (
            bn.weight.view(c) * (t.float() - bn.running_mean.view(c))
            * torch.rsqrt(bn.running_var + bn.eps).view(c) + bn.bias.view(c)).to(t.dtype),
        "exported_eval_addcmul": bn._exported_eval,
    }
    part2 = {}
    for name, fn in forms.items():
        torch._dynamo.reset()
        with torch.no_grad():
            part2[name] = int((torch.compile(fn, dynamic=False)(x) != eager).sum())
    print(json.dumps({"compiled_vs_eager_mismatches": part2}))

    # 3: the released model, bf16, against float32 on phase 4's 8 frames
    _, frames = serving_frames(0)
    imgs = (torch.from_numpy(frames).cuda().float() / 255.0).expand(-1, -1, -1, 3).contiguous()
    assert imgs.shape[1:3] == (H, W)
    fe = SuperPointFrontend(SuperPointConfig(), weights_path=released_path(), device="cuda")
    torch.backends.cudnn.allow_tf32 = False
    fe32 = SuperPointFrontend(SuperPointConfig(compute_dtype="float32"),
                              weights_path=released_path(), device="cuda")
    with torch.inference_mode():
        lg32, d32 = fe32.model.features(imgs)
        lg16, d16 = fe.model.features(imgs)
    torch.backends.cudnn.allow_tf32 = True
    p32 = decode_prob_map(lg32, 8)
    eager_forward = BatchNorm2d.forward

    def exported_forward(self, t):
        return self._exported_eval(t)

    # Inductor's BatchNorm through `nn.BatchNorm2d.forward` itself: under
    # ``torch.compile`` some torch versions report `is_exporting`, which
    # would send `BatchNorm2d.forward` to `_exported_eval`
    runs = {"eager": (lg16, d16)}
    for name, fwd in (("compiled_inductor_batchnorm", torch.nn.BatchNorm2d.forward),
                      ("compiled_exported_eval", exported_forward)):
        BatchNorm2d.forward = fwd
        torch._dynamo.reset()
        with torch.inference_mode():
            runs[name] = torch.compile(fe.model.features, dynamic=False)(imgs)
        BatchNorm2d.forward = eager_forward
    part3 = {}
    for name, (lg, d) in runs.items():
        p = decode_prob_map(lg.float(), 8)
        part3[name] = dict(
            logits_not_eager=int((lg != lg16).sum()),
            prob_vs_f32_max=float((p - p32).abs().max()),
            prob_vs_f32_mean=float((p - p32).abs().mean()),
            desc_vs_f32_mean=float((d.float() - d32.float()).abs().mean()))
    print(json.dumps({"model_bf16_480x640_b8": part3, "logits": lg16.numel()}))
    print(card)
    return 0 if part2["exported_eval_addcmul"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
