"""Checkpoint saving — PyTorch port of ``omchat_tpu/checkpoint/save.py``.

- :func:`flatten_to_hf_state`, :func:`save_hf_safetensors` and
  :func:`export_hf_bundle`: the port's param tree in the HF-bundle key layout
  (``vision_tower.*``, ``multi_modal_projector.*``, ``language_model.*``,
  linear weights [out, in], one tensor a layer), the same tensors, dtypes and
  bytes as the JAX package's writer for the same weights, so the bundle loads
  in either package's loader and, with the standalone code files of
  ``omchat_torch/export/hf_code/``, through ``AutoModel.from_pretrained(...,
  trust_remote_code=True)``;
- :func:`save_mm_projector`: the stage-1 ``mm_projector.safetensors``, in the
  HF-bundle layout (``multi_modal_projector.linear_N.{weight,bias}``, weights
  [out, in]) the JAX package writes, so either package loads the other's.
- :func:`save_lora_adapter`: ``adapter_model.safetensors`` (``layers.{group}.
  {name}.{a,b}``, stacked [L, ...]) + ``adapter_config.json``, the JAX
  package's format.
- :class:`TrainCheckpointer`: train-state save and auto-resume on
  ``torch.save`` with the JAX checkpointer's contract (save a step, find the
  latest, restore into a template, keep the newest ``max_to_keep``).  Its
  files are the port's own: orbax checkpoints of the JAX trainer do not load
  here, nor these there.

A staged pipeline-parallel layer tree has no counterpart in the port until
the parallelism slice; its refusal (``save.py:68-74`` of the JAX package)
comes with it.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, Optional

import torch


def _cpu(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu").contiguous()


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CPU copy with its own storage: safetensors writes a
    tensor's buffer and refuses tensors that share one (a layer of a stacked
    leaf is a view of the stack)."""
    return t.detach().to("cpu", copy=True).contiguous()


def flatten_to_hf_state(params: dict) -> Dict[str, torch.Tensor]:
    """The inverse of ``loader.convert_omchat_state_dict``: the port's param
    tree → flat HF-layout tensors (linear weights transposed to [out, in],
    layers unstacked), CPU, contiguous, each with its own storage.  Covers
    the InternViT tower (norm and qkv biases and q / k norms when present),
    the dense and MoE trunks (experts, shared expert and its gate), an
    untied ``lm_head``, the projector's linears and the v1
    ``image_newline``."""
    out: Dict[str, torch.Tensor] = {}

    def vis(p: dict, prefix: str):
        out[f"{prefix}embeddings.class_embedding"] = _own(p["class_embedding"].reshape(1, 1, -1))
        out[f"{prefix}embeddings.position_embedding"] = _own(p["position_embedding"][None])
        out[f"{prefix}embeddings.patch_embedding.weight"] = _own(p["patch_embedding"]["kernel"])  # OIHW already
        out[f"{prefix}embeddings.patch_embedding.bias"] = _own(p["patch_embedding"]["bias"])
        layers = p["layers"]
        attn, mlp = layers["attn"], layers["mlp"]
        for i in range(layers["ls1"].shape[0]):
            lp = f"{prefix}encoder.layers.{i}."
            out[lp + "norm1.weight"] = _own(layers["norm1"]["scale"][i])
            out[lp + "norm2.weight"] = _own(layers["norm2"]["scale"][i])
            if "bias" in layers["norm1"]:
                out[lp + "norm1.bias"] = _own(layers["norm1"]["bias"][i])
                out[lp + "norm2.bias"] = _own(layers["norm2"]["bias"][i])
            out[lp + "ls1"] = _own(layers["ls1"][i])
            out[lp + "ls2"] = _own(layers["ls2"][i])
            out[lp + "attn.qkv.weight"] = _own(attn["qkv"]["kernel"][i].t())
            if "bias" in attn["qkv"]:
                out[lp + "attn.qkv.bias"] = _own(attn["qkv"]["bias"][i])
            out[lp + "attn.proj.weight"] = _own(attn["proj"]["kernel"][i].t())
            out[lp + "attn.proj.bias"] = _own(attn["proj"]["bias"][i])
            if "q_norm" in attn:
                out[lp + "attn.q_norm.weight"] = _own(attn["q_norm"]["scale"][i])
                out[lp + "attn.k_norm.weight"] = _own(attn["k_norm"]["scale"][i])
            for name in ("fc1", "fc2"):
                out[lp + f"mlp.{name}.weight"] = _own(mlp[name]["kernel"][i].t())
                out[lp + f"mlp.{name}.bias"] = _own(mlp[name]["bias"][i])

    def lm(p: dict, prefix: str):
        out[f"{prefix}model.embed_tokens.weight"] = _own(p["embed_tokens"])
        layers = p["layers"]
        for i in range(layers["input_layernorm"]["scale"].shape[0]):
            lp = f"{prefix}model.layers.{i}."
            out[lp + "input_layernorm.weight"] = _own(layers["input_layernorm"]["scale"][i])
            out[lp + "post_attention_layernorm.weight"] = _own(layers["post_attention_layernorm"]["scale"][i])
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                pp = layers["self_attn"][name]
                out[lp + f"self_attn.{name}.weight"] = _own(pp["kernel"][i].t())
                if "bias" in pp:
                    out[lp + f"self_attn.{name}.bias"] = _own(pp["bias"][i])
            mlp = layers["mlp"]
            if "gate_proj" in mlp:  # dense
                for name in ("gate_proj", "up_proj", "down_proj"):
                    out[lp + f"mlp.{name}.weight"] = _own(mlp[name]["kernel"][i].t())
            else:  # MoE
                out[lp + "mlp.gate.weight"] = _own(mlp["gate"]["kernel"][i].t())
                for j in range(mlp["experts"]["gate_proj"].shape[1]):
                    for name in ("gate_proj", "up_proj", "down_proj"):
                        out[lp + f"mlp.experts.{j}.{name}.weight"] = _own(mlp["experts"][name][i, j].t())
                for name in ("gate_proj", "up_proj", "down_proj"):
                    out[lp + f"mlp.shared_expert.{name}.weight"] = _own(mlp["shared_expert"][name]["kernel"][i].t())
                out[lp + "mlp.shared_expert_gate.weight"] = _own(mlp["shared_expert_gate"]["kernel"][i].t())
        out[f"{prefix}model.norm.weight"] = _own(p["norm"]["scale"])
        if "lm_head" in p:
            out[f"{prefix}lm_head.weight"] = _own(p["lm_head"]["kernel"].t())

    vis(params["vision_tower"], "vision_tower.")
    for name, pp in params.get("projector", {}).items():
        out[f"multi_modal_projector.{name}.weight"] = _own(pp["kernel"].t())
        if "bias" in pp:
            out[f"multi_modal_projector.{name}.bias"] = _own(pp["bias"])
    lm(params["language_model"], "language_model.")
    if "image_newline" in params:  # v1 spatial_unpad newline embedding
        out["image_newline"] = _own(params["image_newline"])
    return out


def save_hf_safetensors(params: dict, directory: str, max_shard_bytes: int = 4 << 30) -> None:
    """Write the tree as safetensors in the HF-bundle layout: shards of at
    most ``max_shard_bytes`` (one tensor may exceed it alone), and the
    ``model.safetensors.index.json`` that ``from_pretrained`` needs when
    there is more than one file."""
    from safetensors.torch import save_file

    os.makedirs(directory, exist_ok=True)
    state = flatten_to_hf_state(params)
    shards, cur, cur_bytes = [], {}, 0
    for k, v in state.items():
        nbytes = v.numel() * v.element_size()
        if cur_bytes + nbytes > max_shard_bytes and cur:
            shards.append(cur)
            cur, cur_bytes = {}, 0
        cur[k] = v
        cur_bytes += nbytes
    shards.append(cur)
    weight_map, total = {}, 0
    for i, shard in enumerate(shards):
        name = "model.safetensors" if len(shards) == 1 else f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        for k, v in shard.items():
            weight_map[k] = name
            total += v.numel() * v.element_size()
        save_file(shard, os.path.join(directory, name))
    if len(shards) > 1:
        with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f)


HF_CODE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "export", "hf_code")
HF_CODE_FILES = ("configuration_omchat.py", "modeling_omchat.py", "processing_omchat.py",
                 "image_processing_omchat.py")
AUTO_MAP = {
    "AutoConfig": "configuration_omchat.OmChatConfig",
    "AutoModel": "modeling_omchat.OmChatForConditionalGeneration",
    "AutoModelForCausalLM": "modeling_omchat.OmChatForConditionalGeneration",
    "AutoProcessor": "processing_omchat.OmChatProcessor",
    "AutoImageProcessor": "image_processing_omchat.OmChatImageProcessor",
}


def export_hf_bundle(config, params: dict, directory: str, source_dir: Optional[str] = None) -> None:
    """Write a complete loadable HF-bundle directory, as the JAX package's
    ``export_hf_bundle`` does: the safetensors (and index), ``config.json``
    (the source checkpoint's, overlaid with ``config.to_hf_dict()`` and the
    ``auto_map``), the ``trust_remote_code`` code files copied from
    ``omchat_torch/export/hf_code/``, ``preprocessor_config.json``,
    ``processor_config.json`` and the tokenizer files of ``source_dir``."""
    os.makedirs(directory, exist_ok=True)
    save_hf_safetensors(params, directory)
    for name in HF_CODE_FILES:
        shutil.copy(os.path.join(HF_CODE_DIR, name), os.path.join(directory, name))

    # config.json: the source checkpoint's (keeps keys the port does not
    # model), overlaid with the canonical HF-bundle fields
    base = {}
    if source_dir and os.path.exists(os.path.join(source_dir, "config.json")):
        with open(os.path.join(source_dir, "config.json")) as f:
            base = json.load(f)
    base.update(config.to_hf_dict())
    base["auto_map"] = AUTO_MAP
    with open(os.path.join(directory, "config.json"), "w") as f:
        json.dump(base, f, indent=2)

    pre = {
        "image_processor_type": "OmChatImageProcessor",
        "processor_class": "OmChatProcessor",
        "auto_map": {
            "AutoImageProcessor": "image_processing_omchat.OmChatImageProcessor",
            "AutoProcessor": "processing_omchat.OmChatProcessor",
        },
        "crop_size": {"height": config.vision.image_size, "width": config.vision.image_size},
        "size": {"shortest_edge": config.vision.image_size},
        "image_grid_pinpoints": [list(p) for p in config.image_grid_pinpoints],
        "image_mean": [0.485, 0.456, 0.406],
        "image_std": [0.229, 0.224, 0.225],
        "do_resize": True,
        "do_center_crop": True,
        "do_rescale": True,
        "do_normalize": True,
        "rescale_factor": 1 / 255,
    }
    with open(os.path.join(directory, "preprocessor_config.json"), "w") as f:
        json.dump(pre, f, indent=2)
    with open(os.path.join(directory, "processor_config.json"), "w") as f:
        json.dump({"processor_class": "OmChatProcessor",
                   "auto_map": {"AutoProcessor": "processing_omchat.OmChatProcessor"}}, f, indent=2)

    if source_dir:
        for name in os.listdir(source_dir):
            if "token" in name or name.endswith(".model") or name == "generation_config.json":
                shutil.copy(os.path.join(source_dir, name), os.path.join(directory, name))


def save_mm_projector(directory: str, projector: dict) -> str:
    """Write a projector-only checkpoint (linear / mlpNx projectors in the
    HF-bundle layout, other projector types under dotted ``projector.``
    keys).  Returns the file path."""
    from safetensors.torch import save_file

    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "mm_projector.safetensors")
    linear_shape = projector and all(
        re.match(r"^linear_\d+$", k) and isinstance(v, dict) and set(v) <= {"kernel", "bias"}
        for k, v in projector.items()
    )
    flat: Dict[str, torch.Tensor] = {}
    if linear_shape:
        for name, p in projector.items():
            flat[f"multi_modal_projector.{name}.weight"] = _cpu(p["kernel"].t())
            if "bias" in p:
                flat[f"multi_modal_projector.{name}.bias"] = _cpu(p["bias"])
    else:
        from omchat_torch.utils.tree import tree_items

        for path_elems, leaf in tree_items(projector):
            flat["projector." + ".".join(path_elems)] = _cpu(leaf)
    save_file(flat, path)
    return path


def save_lora_adapter(directory: str, lora: dict, *, base_model: Optional[str] = None) -> None:
    """Write a LoRA adapter tree as ``adapter_model.safetensors`` +
    ``adapter_config.json`` (loadable by both packages'
    ``load_lora_adapter`` and ``load_pretrained_model(lora_path=...)``)."""
    from safetensors.torch import save_file

    os.makedirs(directory, exist_ok=True)
    flat: Dict[str, torch.Tensor] = {}
    targets = set()
    rank = None
    for group, adapters in lora["layers"].items():
        for name, ab in adapters.items():
            flat[f"layers.{group}.{name}.a"] = _cpu(ab["a"])
            flat[f"layers.{group}.{name}.b"] = _cpu(ab["b"])
            targets.add(name)
            rank = int(ab["a"].shape[-1])
    save_file(flat, os.path.join(directory, "adapter_model.safetensors"))
    cfg = {"format": "omchat-tpu-lora", "scale": float(lora["scale"]), "rank": rank, "targets": sorted(targets)}
    if base_model:
        cfg["base_model"] = base_model
    with open(os.path.join(directory, "adapter_config.json"), "w") as f:
        json.dump(cfg, f, indent=2)


def _copy_into(template, loaded):
    """``loaded``'s values in ``template``'s structure: tensors are copied into
    the template's own (keeping their device, dtype and requires_grad),
    everything else is taken from ``loaded``."""
    if isinstance(template, dict):
        return {k: _copy_into(template[k], loaded[k]) for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_copy_into(t, l) for t, l in zip(template, loaded))
    if isinstance(template, torch.Tensor):
        with torch.no_grad():
            template.copy_(loaded)
        return template
    return loaded


class TrainCheckpointer:
    """Train-state save + latest-step auto-resume on ``torch.save``:
    ``<directory>/step_<N>/state.pt``, written through a temporary name and
    renamed, so a cut save leaves no half checkpoint."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _steps(self):
        steps = []
        for name in os.listdir(self.directory):
            m = re.match(r"^step_(\d+)$", name)
            if m and os.path.exists(os.path.join(self.directory, name, "state.pt")):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def save(self, step: int, state) -> None:
        final = os.path.join(self.directory, f"step_{step}")
        tmp = final + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, "state.pt"))
        shutil.rmtree(final, ignore_errors=True)
        os.replace(tmp, final)
        for old in self._steps()[: -self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{old}"), ignore_errors=True)

    def latest_step(self) -> Optional[int]:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore(self, state_template):
        """Restore the latest checkpoint into the template's structure (and
        its tensors); returns (state, step), or (template, None) when there
        is none."""
        step = self.latest_step()
        if step is None:
            return state_template, None
        loaded = torch.load(os.path.join(self.directory, f"step_{step}", "state.pt"), map_location="cpu",
                            weights_only=True)
        return _copy_into(state_template, loaded), step
