"""Phase 28 of ``chip_smoke.py`` alone (the paged engine's routes: prefix
cache, speculative verify in the batch, streaming and pipelined rolls, and
their three kernel rows) at full width and depth on random bf16 weights
(seed 0).  Needs one NVIDIA GPU:

    python3 chip_probes/paged_routes.py [--parts a,b,c,rows]

``a`` the prefix cache, ``b`` the verify's logits and the echo workload,
``c`` streaming and pipelined rolls (phase 27 is not run, so its numbers
are not printed beside), ``rows`` the kernel rows (needs ``a`` and ``b``).
"""
import argparse
import subprocess
import sys

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from omchat_torch.ops import kernel_lib  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--parts", default="a,b,c,rows")
parts = set(ap.parse_args().parts.split(","))

import torch  # noqa: E402

cs.CARD = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
cs.log(cs.CARD)
kernel_lib.build_all()
model = cs.surface_model(*cs.full_model(0))
gen = torch.Generator(device="cuda").manual_seed(0)
failed = []
runs = (("a", lambda: cs.prefix_cache_routes(model)),
        ("b", lambda: cs.verify_vs_decode(model, cs.small_surface(model.config, 0))),
        ("b", lambda: cs.speculative_in_the_batch(model)),
        ("c", lambda: cs.streaming_and_pipelined(model, 0)))
for part, run in runs:
    if part in parts:
        try:
            run()
        except AssertionError as e:
            failed.append(f"({part}) {e}")
        torch.cuda.empty_cache()
if "rows" in parts and "chunks" in cs.ROUTES_SEEN and "verify" in cs.ROUTES_SEEN:
    try:
        cs.routes_kernel_rows(gen, cs.ROUTES_SEEN["verify"], cs.ROUTES_SEEN["chunks"])
    except AssertionError as e:
        failed.append(f"kernel rows: {e}")
if failed:
    sys.exit(" | ".join(failed))
