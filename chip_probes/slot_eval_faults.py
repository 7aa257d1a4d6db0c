"""The readings that set two limits of ``chip_smoke.py``'s phases 29-30 at
full width and 2+2 layers (random bf16 weights, seed 0): the perplexity's
largest per-token nll gap, kernels against the plain route and the plain
route with each planted fault (``PPL_FAULTS``), over several seeded texts;
and the slot engine's LoRA-bank check (bank against merged weights, then the
batch with adapters 1 and 2 swapped and with the bank ignored) over several
adapter seeds and B's std.  A limit belongs between the largest sound gap and the
smallest fault.  Needs one NVIDIA GPU:

    python3 chip_probes/slot_eval_faults.py [--seeds 0,1,2] [--lora-b-std 0.001,0.004]
"""
import argparse
import json
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--seeds", default="0,1,2")
ap.add_argument("--lora-b-std", default="0.001,0.004", help="the adapters' B std (chip_smoke's LORA_B_STD) to read")
args = ap.parse_args()
seeds = [int(s) for s in args.seeds.split(",")]
stds = [float(s) for s in args.lora_b_std.split(",")]

from omchat_torch.api import omchat_model  # noqa: E402
from omchat_torch.config import OmChatConfig  # noqa: E402
from omchat_torch.runtime.generate import OmChatEngine  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
cs.log(f"kernel build: {kernel_lib.build_all():.1f} s")
small = cs.small_surface(OmChatConfig(), 0)
kernels = omchat_model(cs.id_tokenizer(False), small.engine)
plain = omchat_model(cs.id_tokenizer(False), OmChatEngine(small.config, small.engine.params, attn_impl="plain",
                                                          image_cache_size=0, device=cs.DEVICE))
directory = tempfile.mkdtemp(prefix="slot-eval-faults-")
for seed in seeds:
    with open(cs.eval_files(directory, seed)[2]) as f:
        cs.log(f"perplexity gaps, text seed {seed}: " + json.dumps({"card": cs.CARD, **cs.perplexity_gaps(
            kernels, plain, f.read())}))
work = cs.serving_workload(small.config)
for std in stds:
    cs.LORA_B_STD = std
    for seed in seeds:
        try:
            res = cs.slot_parity_small(small, work, seed)
            cs.log(f"slot LoRA bank, B std {std}, adapter seed {seed}: " + json.dumps({"card": cs.CARD, **res}))
        except AssertionError as e:
            cs.log(f"slot LoRA bank, B std {std}, adapter seed {seed}: FAILED {e}")
shutil.rmtree(directory, ignore_errors=True)
