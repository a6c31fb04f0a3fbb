"""Time each GEMM of the bf16 ResNet chains (K3/K4, ``csrc/conv_wgmma.cu``)
alone at the main path's shapes, on one GPU:

    python3 -m sequoia_tpu_torch.chain_gemms

Per launch of one stride-1 block of each stage (extractor batch 128, 256-px
patches): ms, TFLOP/s and the bytes it must move (inputs read once, output
written once) per ms.  Then what K3 pays around the kernel: PyTorch's
(C, P) -> (P, C) transpose in and the last launch writing (C, P) itself
against a (P, C) launch plus PyTorch's transpose out.  Then two yardsticks of
the card's memory rate through PyTorch (an add and a copy of 268 MB).  One
JSON object per line; the card's name and power limit first.  Needs CUDA.
"""

from __future__ import annotations

import json
import subprocess
import sys

BATCH = 128
# (stage, H, cin, width, cout) of an identity block, and layer1's projection block
BLOCKS = ((1, 64, 256, 64, 256), (2, 32, 512, 128, 512), (3, 16, 1024, 256, 1024),
          (4, 8, 2048, 512, 2048))


def _time_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    from sequoia_tpu_torch.ops import cuda_resnet as cr

    if not torch.cuda.is_available():
        print("chain_gemms: needs a CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}))
    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def emit_gemm(stage, name, mode, X, Wop, N, **kw):
        bias = torch.randn((N,), generator=g, device=dev)
        ms = _time_ms(torch, lambda: cr._wg_gemm(mode, X, Wop, bias, N=N, kmajor=False,
                                                 counter="bottleneck_chain", **kw))
        K = Wop.shape[0]
        moved = sum(t.numel() * t.element_size() for t in (X, kw.get("X2"), kw.get("R"))
                    if t is not None) + X.shape[0] * X.shape[1] * N * 2
        flops = 2 * X.shape[0] * X.shape[1] * K * N
        print(json.dumps({"stage": stage, "gemm": name, "K": K, "N": N, "ms": ms,
                          "tflops": flops / ms / 1e9, "bytes_tb_per_s": moved / ms / 1e9}))

    for stage, H, cin, w, cout in BLOCKS:
        P = H * H
        x, y = rand(BATCH, P, cin), rand(BATCH, P, w)
        emit_gemm(stage, "conv1", cr._PC_PLAIN, x, rand(cin, w, scale=cin ** -0.5), w, K=cin)
        emit_gemm(stage, "conv2_taps", cr._PC_TAPS3, y, rand(9 * w, w, scale=(9 * w) ** -0.5),
                  w, K=9 * w, W=H, C=w)
        emit_gemm(stage, "conv3_residual", cr._PC_PLAIN, y, rand(w, cout, scale=w ** -0.5),
                  cout, K=w, R=x)
        if stage == 1:  # layer1's first block: 64 channels in, conv3 + projection
            x64 = rand(BATCH, P, 64)
            emit_gemm(stage, "conv1_from_64", cr._PC_PLAIN, x64, rand(64, w, scale=0.125), w,
                      K=64)
            emit_gemm(stage, "conv3_projection", cr._PC_CONCAT, y,
                      rand(w + 64, cout, scale=(w + 64) ** -0.5), cout, K=w + 64, K1=w,
                      X2=x64)

    # K3 at layer1: the transpose in, and its last launch writing (C, P)
    # against a (P, C) launch plus PyTorch's transpose out
    P, w, cout = 64 * 64, 64, 256
    x_cp = rand(BATCH, 64, P)
    t_in = _time_ms(torch, lambda: x_cp.transpose(1, 2).contiguous())
    y, res = rand(BATCH, P, w), rand(BATCH, P, cout)
    w3, b3 = rand(cout, w, scale=w ** -0.5), torch.randn((cout,), generator=g, device=dev)
    kw = dict(K=w, N=cout, kmajor=True, counter="bottleneck_chain_cp", R=res)
    fused = _time_ms(torch, lambda: cr._wg_gemm(cr._PC_PLAIN, y, w3, b3, out_cp=True, **kw))
    split = _time_ms(torch, lambda: cr._wg_gemm(cr._PC_PLAIN, y, w3, b3, **kw)
                     .transpose(1, 2).contiguous())
    print(json.dumps({"k3_layer1": {"transpose_in_ms": t_in, "last_launch_cp_out_ms": fused,
                                    "last_launch_then_transpose_ms": split}}))

    a = rand(BATCH, P, cout)
    b, c = torch.empty_like(a), torch.empty_like(a)
    mb = a.numel() * 2 / 1e6
    add_ms = _time_ms(torch, lambda: torch.add(a, res, out=c))
    copy_ms = _time_ms(torch, lambda: b.copy_(a))
    print(json.dumps({"torch_add": {"mb_each": mb, "ms": add_ms,
                                    "tb_per_s": 3 * mb / add_ms / 1e3},
                      "torch_copy": {"ms": copy_ms, "tb_per_s": 2 * mb / copy_ms / 1e3}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
