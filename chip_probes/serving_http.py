"""Phase 27 of ``chip_smoke.py`` alone (the server over HTTP on both routes,
paged log-probs with their planted faults, sampled rolls on the graph, the
LoRA bank), after phase 26's speculative decoding (C4's full-depth limit and
its planted faults), at full width and depth on random bf16 weights (seed
0).  Needs one NVIDIA GPU:

    python3 chip_probes/serving_http.py [--skip-speculative]
"""
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
kernel_lib.build_all()
model = cs.surface_model(*cs.full_model(0))
small = cs.small_surface(model.config, 0)
failed = []
if "--skip-speculative" not in sys.argv:
    ids, tiles = cs.make_request(model.config, 0)
    try:
        cs.speculative_on_the_card(model, small, ids, tiles)
    except AssertionError as e:
        failed.append(f"speculative: {e}")
try:
    cs.serving_on_the_card(model, small, 0)
except AssertionError as e:
    failed.append(str(e))
if failed:
    sys.exit(" | ".join(failed))
