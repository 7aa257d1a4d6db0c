"""C-Abstractor (Honeybee) projector, a convolutional token compressor —
PyTorch port of ``omchat_tpu/models/cabstractor.py``.

Learned position embeddings → RegStage(depth) → adaptive average pool to
√n_query × √n_query → RegStage(depth) → readout MLP (Linear + (SiLU +
Linear) × (mlp_depth − 1)): 1024 tokens become ``n_query``.

A RegStage block is timm's Bottleneck as the reference builds it
(``bottle_ratio=1, group_size=1, se_ratio=0.25``, SiLU, LayerNorm2d with eps
1e-6): 1×1 conv → LN → SiLU; the depthwise 3×3 conv → LN → SiLU; SE (1×1
convs with bias, a sigmoid gate); 1×1 conv → LN; the shortcut (1×1 conv + LN
where the channels change); SiLU after the sum.  Convs are bias-free.

Activations run channels-last ([B, H, W, C]), as in the JAX package; the conv
kernels are OIHW for ``F.conv2d`` (``from_jax_params`` turns the JAX
package's HWIO kernels, :func:`convert_honeybee_state_dict` keeps the
reference's).
"""

from __future__ import annotations

import math
import re
from typing import Dict

import torch
import torch.nn.functional as F

from omchat_torch.config import ProjectorConfig
from omchat_torch.ops.linear import silu
from omchat_torch.ops.norms import layer_norm

_LN_EPS = 1e-6  # timm's LayerNorm2d default, not torch's 1e-5


def _conv(x: torch.Tensor, kernel: torch.Tensor, *, depthwise: bool = False) -> torch.Tensor:
    """Bias-free conv of a channels-last x with an OIHW kernel, SAME padding."""
    y = F.conv2d(x.permute(0, 3, 1, 2), kernel, padding=kernel.shape[-1] // 2,
                 groups=x.shape[-1] if depthwise else 1)
    return y.permute(0, 2, 3, 1)


def _ln2d(x: torch.Tensor, p: dict) -> torch.Tensor:
    return layer_norm(x, p["scale"], p["bias"], eps=_LN_EPS)


def _se(x: torch.Tensor, p: dict) -> torch.Tensor:
    """Squeeze-excite: the global mean → fc1 → SiLU → fc2 → a sigmoid gate."""
    s = silu(x.mean(dim=(1, 2)) @ p["fc1"]["kernel"] + p["fc1"]["bias"])
    s = s @ p["fc2"]["kernel"] + p["fc2"]["bias"]
    return x * torch.sigmoid(s)[:, None, None, :]


def _bottleneck(x: torch.Tensor, p: dict) -> torch.Tensor:
    out = silu(_ln2d(_conv(x, p["conv1"]["kernel"]), p["norm1"]))
    out = silu(_ln2d(_conv(out, p["conv2"]["kernel"], depthwise=True), p["norm2"]))
    out = _ln2d(_conv(_se(out, p["se"]), p["conv3"]["kernel"]), p["norm3"])
    if "downsample" in p:
        x = _ln2d(_conv(x, p["downsample"]["conv"]["kernel"]), p["downsample"]["norm"])
    return silu(out + x)


def _adaptive_avg_pool(x: torch.Tensor, out_hw: int) -> torch.Tensor:
    """AdaptiveAvgPool2d of a channels-last x: exact where the grid divides,
    torch's bins (start ⌊i h / out⌋, end ⌈(i + 1) h / out⌉) where it does not."""
    b, h, w, c = x.shape
    if h % out_hw == 0 and w % out_hw == 0:
        return x.reshape(b, out_hw, h // out_hw, out_hw, w // out_hw, c).mean(dim=(2, 4))
    x = torch.stack([x[:, (i * h) // out_hw : -(-((i + 1) * h) // out_hw)].mean(dim=1) for i in range(out_hw)], dim=1)
    return torch.stack([x[:, :, (j * w) // out_hw : -(-((j + 1) * w) // out_hw)].mean(dim=2) for j in range(out_hw)],
                       dim=2)


def cabstractor_forward(params: dict, cfg: ProjectorConfig, features: torch.Tensor) -> torch.Tensor:
    """[B, L, mm_hidden] → [B, n_query, hidden]."""
    b, l, d = features.shape
    hw = math.isqrt(l)
    x = features
    if "pos_emb" in params:
        x = x + params["pos_emb"].to(x.dtype)
    x = x.reshape(b, hw, hw, d)
    for p in params["s1"]:
        x = _bottleneck(x, p)
    x = _adaptive_avg_pool(x, math.isqrt(cfg.n_query))
    for p in params["s2"]:
        x = _bottleneck(x, p)
    x = x.reshape(b, cfg.n_query, -1)
    x = x @ params["readout"][0]["kernel"] + params["readout"][0]["bias"]
    for p in params["readout"][1:]:
        x = silu(x) @ p["kernel"] + p["bias"]
    return x


def init_params(cfg: ProjectorConfig, mm_hidden: int, out_hidden: int, generator: torch.Generator,
                dtype=torch.float32, device=None, hidden: int = 1024, num_input_tokens: int = 1024) -> dict:
    """Random weights from a seeded generator (the JAX ``init_params``
    distribution: normal(0, 0.02) kernels, zero biases, unit norms)."""
    device = device if device is not None else generator.device

    def nrm(*shape):
        return torch.randn(shape, generator=generator, device=device).mul_(0.02).to(dtype)

    def zeros(c):
        return torch.zeros((c,), dtype=dtype, device=device)

    def norm(c):
        return {"scale": torch.ones((c,), dtype=dtype, device=device), "bias": zeros(c)}

    def block(i, o):
        rd = int(round(i * 0.25))
        p = {
            "conv1": {"kernel": nrm(o, i, 1, 1)},
            "norm1": norm(o),
            "conv2": {"kernel": nrm(o, 1, 3, 3)},  # depthwise
            "norm2": norm(o),
            "se": {"fc1": {"kernel": nrm(o, rd), "bias": zeros(rd)},
                   "fc2": {"kernel": nrm(rd, o), "bias": zeros(o)}},
            "conv3": {"kernel": nrm(o, o, 1, 1)},
            "norm3": norm(o),
        }
        if i != o:
            p["downsample"] = {"conv": {"kernel": nrm(o, i, 1, 1)}, "norm": norm(o)}
        return p

    readout = [{"kernel": nrm(hidden, out_hidden), "bias": zeros(out_hidden)}]
    readout += [{"kernel": nrm(out_hidden, out_hidden), "bias": zeros(out_hidden)} for _ in range(cfg.mlp_depth - 1)]
    return {
        "pos_emb": nrm(num_input_tokens, mm_hidden),
        "s1": [block(mm_hidden if j == 0 else hidden, hidden) for j in range(cfg.depth)],
        "s2": [block(hidden, hidden) for _ in range(cfg.depth)],
        "readout": readout,
    }


def convert_honeybee_state_dict(state: Dict[str, torch.Tensor], cfg: ProjectorConfig, dtype=torch.float32) -> dict:
    """The reference honeybee CAbstractor's state dict → tree.  Keys (timm
    naming, ``net = Sequential(s1, pool, s2)``): ``net.{0,2}.bN.conv{1,2,3}.
    {conv,bn}.*``, ``net.*.bN.se.fc*``, ``net.*.bN.downsample.{conv,bn}.*``,
    ``readout.{0,2,4…}``, ``pos_emb``."""
    def a(k):
        return torch.as_tensor(state[k]).to(dtype).contiguous()

    def norm(prefix):
        return {"scale": a(f"{prefix}.weight"), "bias": a(f"{prefix}.bias")}

    def fc(prefix):  # a 1x1 conv with bias as a linear [in, out]
        return {"kernel": a(f"{prefix}.weight")[:, :, 0, 0].t().contiguous(), "bias": a(f"{prefix}.bias")}

    def block(prefix):
        p = {
            "conv1": {"kernel": a(f"{prefix}.conv1.conv.weight")},
            "norm1": norm(f"{prefix}.conv1.bn"),
            "conv2": {"kernel": a(f"{prefix}.conv2.conv.weight")},
            "norm2": norm(f"{prefix}.conv2.bn"),
            "se": {"fc1": fc(f"{prefix}.se.fc1"), "fc2": fc(f"{prefix}.se.fc2")},
            "conv3": {"kernel": a(f"{prefix}.conv3.conv.weight")},
            "norm3": norm(f"{prefix}.conv3.bn"),
        }
        if f"{prefix}.downsample.conv.weight" in state:
            p["downsample"] = {"conv": {"kernel": a(f"{prefix}.downsample.conv.weight")},
                               "norm": norm(f"{prefix}.downsample.bn")}
        return p

    params = {
        "s1": [block(f"net.0.b{i + 1}") for i in range(cfg.depth)],
        "s2": [block(f"net.2.b{i + 1}") for i in range(cfg.depth)],
    }
    if "pos_emb" in state:
        params["pos_emb"] = a("pos_emb")[0]
    idxs = sorted(int(m.group(1)) for k in state if (m := re.match(r"^readout\.(\d+)\.weight$", k)))
    params["readout"] = [{"kernel": a(f"readout.{i}.weight").t().contiguous(), "bias": a(f"readout.{i}.bias")}
                         for i in idxs]
    return params
