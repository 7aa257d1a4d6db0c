"""Device time of the single-image request's stages (ViT + projector,
prefill, one decode step), bf16 and w8a8, at full width and depth on random
weights, by ``torch.profiler``: the kernels' time grouped (the port's CUDA
kernels by name, int8 GEMMs, bf16 GEMMs, elementwise and copy passes, the
rest) and the largest kernels.  Needs one NVIDIA GPU:

    python3 chip_probes/profile_stages.py
"""
import gc
import sys

sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from omchat_torch import api
from omchat_torch.config import OmChatConfig
from omchat_torch.runtime.generate import OmChatEngine

OURS = ("qk_norm_prepass", "flash_fwd", "flash_decode_stacked", "commit_rows",
        "add_rmsnorm_quant", "rmsnorm_quant", "fc1_gelu_quant", "proj_glue_quant")  # add_... before its suffix


def group(name: str) -> str:
    for k in OURS:
        if k in name:
            return k
    if "gemm_s8" in name or "i16832gemm" in name or "imma" in name:
        return "int8 GEMM (torch._int_mm)"
    if name.startswith("nvjet") or "gemm" in name or "cutlass" in name:
        return "bf16 GEMM"
    if "elementwise" in name or "reduce_kernel" in name or "copy" in name.lower() or "Memcpy" in name:
        return "elementwise, copy, reduce"
    return "other"


def kernels(prof):
    """(name, device ms, count) of the device-side events (kernels), not the aten ops."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = out.get(e.name, (0.0, 0))
            out[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    return out


cfg = OmChatConfig()
ids, tiles = cs.make_request(cfg, 0)
card = torch.cuda.get_device_name(0)
for label in ("w8a8", "bf16"):
    params = cs.build_model(cfg, 0)
    c = cfg
    if label == "w8a8":
        c, params = api.quantize_model(cfg, params, w8a8=True)
    eng = OmChatEngine(c, params, image_cache_size=0)
    plan = eng.plan([ids])
    for _ in range(2):  # warm-up: cuBLAS plans, the allocator, the kernels' first launches
        feats = eng.encode_images(tiles)
        logits, cache = eng.prefill(plan, feats, 32)
        tok = logits.argmax(-1).int()
        kv = torch.as_tensor(plan.lengths, device="cuda")
        eng.decode_step(tok, kv, cache)
    torch.cuda.synchronize()
    for stage, fn in (("vit", lambda: eng.encode_images(tiles)), ("prefill", lambda: eng.prefill(plan, feats, 32)),
                      ("decode_step", lambda: eng.decode_step(tok, kv, cache))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        ks = kernels(prof)
        if not ks:  # no device-side events: the operators' device time instead
            ks = {e.key: (e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
                  if e.self_device_time_total and not e.key.startswith("aten::")}
        groups = {}
        for name, (ms, n) in ks.items():
            g = groups.setdefault(group(name), [0.0, 0])
            g[0] += ms
            g[1] += n
        total = sum(ms for ms, _ in ks.values())
        print(f"== {label} {stage} ({card}): kernel time {total:.3f} ms, {sum(n for _, n in ks.values())} kernels")
        for g, (ms, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            print(f"   {ms:9.3f} ms  {100 * ms / total:5.1f}%  x{n:5d}  {g}")
        for name, (ms, n) in sorted(ks.items(), key=lambda kv: -kv[1][0])[:6]:
            print(f"      top {ms:8.3f} ms x{n:4d} {name[:100]}")
    del eng, params, cache
    gc.collect()
    torch.cuda.empty_cache()
