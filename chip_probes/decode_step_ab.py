"""The single-image request's bf16 decode step at full width and depth
(``chip_smoke.py``'s random model and request, after its prefill), timed from
the ``omchat_torch`` package under ``--root``, so that two trees (a parent
commit unpacked with ``git archive``, and this one) are read on one card in
one call, in turns: parent, change, change, parent.

    python3 chip_probes/decode_step_ab.py --root _chip/parent --label parent
    python3 chip_probes/decode_step_ab.py --root . --label change

A step is what ``OmChatEngine.generate`` runs for each token, read on two
routes where the tree has them:

- "eager": ``decode_step`` (28 layers, K3 in each, one K4 commit) and the
  greedy argmax issued from the host, then the token read back;
- "graphed" (trees whose engine keeps a decode state, ``decode_state``):
  one replay of the CUDA graph of the state's step (the same work, the
  greedy pick and the state's updates inside it), then the token read back.
  The graph is captured once before the readings; every reading starts
  from the prompt's length, as the eager route's steps do.

Prints one JSON line: the card, the label and, per route, the step's wall ms
(host clock over ``STEPS`` steps, median of ``READINGS`` readings), the
host's time to issue a step (before the readback waits for the card; median
over the same steps) and, from ``torch.profiler`` over ``PROFILED`` steps,
the device time a step of all its kernels and of the decode-attention
kernels (names holding "decode"), and the device's busy share of the wall
time.  Needs one NVIDIA GPU.
"""
import argparse
import json
import os
import subprocess
import sys
import time

READINGS, STEPS, PROFILED = 5, 20, 5


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the omchat_torch package to time")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from omchat_torch.config import OmChatConfig
    from omchat_torch.ops import kernel_lib
    from omchat_torch.runtime.generate import OmChatEngine

    if not torch.cuda.is_available():
        print("decode_step_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    kernel_lib.build_all()
    cfg = OmChatConfig()
    ids, tiles = cs.make_request(cfg, 0)
    eng = OmChatEngine(cfg, cs.build_model(cfg, 0), image_cache_size=0)
    plan = eng.plan([ids])
    feats = eng.encode_images(tiles)
    logits, cache = eng.prefill(plan, feats, cs.NEW_TOKENS)
    kv_len = torch.as_tensor(plan.lengths, device="cuda")
    tokens = logits.argmax(-1).int()

    def eager(issue=None):
        t0 = time.perf_counter()
        step_logits, _ = eng.decode_step(tokens, kv_len, cache)
        top = step_logits.argmax(-1)
        if issue is not None:
            issue.append((time.perf_counter() - t0) * 1e3)
        top.cpu()

    routes = {"eager": (eager, lambda: None)}
    if hasattr(eng, "decode_state"):
        st = eng.decode_state(1, eng.cache_rows(plan, cs.NEW_TOKENS))
        first, _ = eng.prefill(plan, feats, cs.NEW_TOKENS, cache=st.cache)
        eng._start(st, first.argmax(-1).int(), plan.lengths, -1)

        def graphed(issue=None):
            t0 = time.perf_counter()
            st.run()
            if issue is not None:
                issue.append((time.perf_counter() - t0) * 1e3)
            st.tokens.cpu()

        def restart():  # back to the prompt's length, in the static buffers the graph reads
            st.kv_len.copy_(kv_len)
            st.step.fill_(1)

        graphed()  # the first step runs eagerly and captures the graph
        routes["graphed"] = (graphed, restart)

    out = {}
    for name, (step, restart) in routes.items():
        restart()
        for _ in range(5):
            step()
        walls, issue = [], []
        for _ in range(READINGS):
            restart()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(STEPS):
                step(issue)
            walls.append((time.perf_counter() - t0) * 1e3 / STEPS)
        restart()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED):
                step()
            torch.cuda.synchronize()
        device = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                device[e.name] = device.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / PROFILED
        wall = sorted(walls)[len(walls) // 2]
        total = sum(device.values())
        out[name] = {"step_wall_ms": wall, "walls": [round(w, 3) for w in walls],
                     "host_issue_ms": sorted(issue)[len(issue) // 2], "device_ms_per_step": total,
                     "device_busy_share": total / wall,
                     "decode_attention_ms_per_step": {n[:80]: v for n, v in device.items() if "decode" in n}}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "label": args.label, **out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
