"""K1, K2 (bf16, e4m3, batched prefill), K5, K14, K16a (the training
forward, LLM, ViT and packed), K16b (the training dQ) and K16c (dK / dV),
the same three, K3
(bf16 and e4m3), K6, K12 and K13 (bf16 and e4m3 pools) at their PERF.md
section-6 shapes, timed from
the ``omchat_torch`` package under ``--root``, so that two trees (a parent
commit unpacked with ``git archive``, and this one) are read on one card in
one call, in turns: parent, change, change, parent.

    python3 chip_probes/attention_ab.py --root _chip/parent --label parent
    python3 chip_probes/attention_ab.py --root . --label change

Each case is the median of 5 readings of 30 launches through the public
wrapper (K1 with its prepass, or, in a tree before the prepass, with its
eager statistics; K16a with its ``q * scale`` pass; K16b given the
backward's prescaled q where its wrapper takes one, ``q_scaled``), the cases
read in turns (``--cases K16a,K3``: only those whose names start so).  The
decode cases walk 28 layers (K3: the stacked cache, at the 31 decode lengths
3187-3217; K12 and K13: a layered page pool at the serving workload's
mid-decode point, 16 requests of 64-2455 rows over 32-page tables) or 28
per-layer caches (K6: length 3188), so that every launch reads from HBM;
"K3", "K3_e4m3", "K6", "K12", "K12_e4m3", "K13" and "K13_e4m3" are one
call's device time (the 28 calls of a walk graphed,
``chip_smoke.graphed``), "... eager" one call issued from the host.
``--k13-rows 256,512`` also reads K13 (graphed, bf16 pool) with its chunks
set to each of those row counts ("K13 rows=256"), to choose the split.
``--save-outputs FILE`` writes K12's and K13's outputs on layer 0 of that
pool (both pools) with ``torch.save``, so that two trees' outputs can be
compared bit for bit.  Prints one JSON line: the card, the label, {case:
median ms} and, under "sha256", a SHA-256 of K16a's (out, lse), K16b's dQ and
K16c's (dK, dV) at each of the three shapes on the same seeded inputs, so
that equal hashes show two trees' K16 give the same bits.  Needs one NVIDIA
GPU.
"""
import argparse
import functools
import hashlib
import inspect
import json
import os
import subprocess
import sys

READINGS, LAUNCHES = 5, 30
BATCHED_KV_LEN = [349, 293, 429, 355, 473, 336, 499, 391]  # the serving run's largest batched prefill
PACKED_DOCS = ((0, 700), (700, 1900), (1900, 2600), (2600, 3900))  # chip_smoke.py's packed K16 case, 4096 rows
# K13: 16 decoding requests at the serving workload's mid-decode point (13471 cached rows in all, as the
# busiest roll of chip_smoke.py's phase 5 holds them), tables of 32 pages of 128 rows
K13_LENGTHS = [2455, 1960, 64, 310, 1475, 130, 705, 1010, 95, 1190, 400, 880, 512, 260, 620, 1405]
K13_WIDTH, K13_POOL_PAGES = 32, 192


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", required=True, help="directory holding the omchat_torch package to time")
    ap.add_argument("--label", required=True)
    ap.add_argument("--cases", default="", help="read only the cases whose names start with one of these "
                                                 "comma-separated prefixes")
    ap.add_argument("--k13-rows", default="", help="comma-separated chunk rows at which to read K13 as well")
    ap.add_argument("--save-outputs", default="", help="torch.save K12's and K13's layer-0 outputs to this file")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    sys.path.insert(0, os.path.abspath(args.root))
    import torch

    from chip_smoke import graphed

    from omchat_torch.ops import decode_attention as da
    from omchat_torch.ops import flash_attention as fa
    from omchat_torch.ops import flash_attention_bwd as fb
    from omchat_torch.ops import kernel_lib
    from omchat_torch.ops import paged_attention as pa
    from omchat_torch.ops.fp8 import to_e4m3

    if not torch.cuda.is_available():
        print("attention_ab: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sources = ("flash_attention.cu", "packed_qkv_norm_attention.cu", "paged_flash_prefill.cu",
               "flash_attention_bwd.cu", "flash_decode_stacked.cu", "paged_flash_decode.cu",
               "paged_flash_decode_manual.cu")
    kernel_lib.build_all(sources)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf)

    # K1 / K5: 3 tiles x 1032 rows (1025 valid), 25 heads of 128
    B, SP, VALID, H, D = 3, 1032, 1025, 25, 128
    qkv = randn(B, SP, 3 * H * D)
    qg = (1 + 0.1 * randn(H * D).float()).to(bf) * fa.packed_prescale(D)
    kg = (1 + 0.1 * randn(H * D).float()).to(bf)
    q5, k5, v5 = qkv.chunk(3, dim=-1)
    # K2: the prompt's 3200 rows over a 3328-row cache layer (3187 valid), 28 / 4 heads; batched: 8 x 512
    S, T, KVL, HQ, KVH = 3200, 3328, 3187, 28, 4
    q2 = randn(1, S, HQ, D)
    k2, v2 = randn(1, KVH, T, D), randn(1, KVH, T, D)
    k8, v8 = to_e4m3(k2), to_e4m3(v2)
    i32 = dict(dtype=torch.int32, device="cuda")
    off1, len1 = torch.zeros(1, **i32), torch.full((1,), KVL, **i32)
    nb = len(BATCHED_KV_LEN)
    qb, kb, vb = randn(nb, 512, HQ, D), randn(nb, KVH, 512, D), randn(nb, KVH, 512, D)
    offb, lenb = torch.zeros(nb, **i32), torch.tensor(BATCHED_KV_LEN, **i32)
    # K14: a 1024-row chunk at position 1024 over 2048 positions in 16 pages of 128, scattered in a 64-page pool
    qc = randn(1, 1024, HQ, D)
    kp, vp = randn(64, KVH, 128, D), randn(64, KVH, 128, D)
    tables = torch.randperm(64, generator=torch.Generator().manual_seed(0))[:16].to(**i32)[None]
    offc, lenc = torch.full((1,), 1024, **i32), torch.full((1,), 2048, **i32)
    # K16a: the stage-1 step's LLM (2 x 3328, 28/4 causal) and ViT (6 x 1025, 25/25) shapes, and a packed 4096
    qt, kt, vt = randn(2, 3328, HQ, D), randn(2, 3328, KVH, D), randn(2, 3328, KVH, D)
    qv, kv, vv = randn(6, VALID, H, D), randn(6, VALID, H, D), randn(6, VALID, H, D)
    qp, kp4, vp4 = randn(1, 4096, HQ, D), randn(1, 4096, KVH, D), randn(1, 4096, KVH, D)
    seg = torch.full((1, 4096), -1, **i32)
    for i, (a, b) in enumerate(PACKED_DOCS):
        seg[:, a:b] = i
    # K16b: the same three shapes, lse and di from the forward
    takes_qs = "q_scaled" in inspect.signature(fb.flash_bwd_dq).parameters
    bwd = {}
    for case, (q_, k_, v_, causal, sg) in {"llm": (qt, kt, vt, True, None), "vit": (qv, kv, vv, False, None),
                                            "packed": (qp, kp4, vp4, True, seg)}.items():
        do_ = randn(*q_.shape)
        out_, lse_ = fb.flash_fwd(q_, k_, v_, causal, sg)
        kw = {"q_scaled": fb._prescaled(q_)} if takes_qs else {}
        bwd[case] = (q_, k_, v_, do_, lse_, fb.flash_di(do_, out_), causal, sg, kw)
        del out_
    # K13: the layered pool [L, P+1, KVH, 128, D] seen flat, each request's pages scattered, walked by layer
    L = 28
    NP = K13_POOL_PAGES + 1
    kpool, vpool = randn(L * NP, KVH, 128, D), randn(L * NP, KVH, 128, D)
    kpool8, vpool8 = to_e4m3(kpool), to_e4m3(vpool)
    perm = torch.randperm(K13_POOL_PAGES, generator=torch.Generator().manual_seed(1)).tolist()
    tab13 = torch.full((len(K13_LENGTHS), K13_WIDTH), K13_POOL_PAGES, dtype=torch.int32)
    used = 0
    for b, n in enumerate(K13_LENGTHS):
        live = -(-n // 128)
        tab13[b, :live] = torch.tensor(perm[used:used + live], dtype=torch.int32)
        used += live
    tab13 = tab13.cuda()
    len13 = torch.tensor(K13_LENGTHS, **i32)
    B13 = len(K13_LENGTHS)
    q13, kn13, vn13 = randn(B13, 1, HQ, D), randn(B13, KVH, D), randn(B13, KVH, D)

    def k13(k, v):
        return pa.paged_flash_decode_manual(q13, k, v, len13, tab13, kn13, vn13, page_offset=(next(step) % L) * NP)

    def k12(k, v):
        return pa.paged_flash_decode(q13, k, v, len13, tab13, kn13, vn13, page_offset=(next(step) % L) * NP)

    if args.save_outputs:
        torch.save({f"{name}{suffix}": fn(q13, k, v, len13, tab13, kn13, vn13).cpu()
                    for name, fn in (("K12", pa.paged_flash_decode), ("K13", pa.paged_flash_decode_manual))
                    for suffix, k, v in (("", kpool, vpool), ("_e4m3", kpool8, vpool8))}, args.save_outputs)


    # K3 / K6: one decode token over 28 layers of a [1, 4, 3328, 128] cache, walked in turn
    kd, vd = randn(L, 1, KVH, T, D), randn(L, 1, KVH, T, D)
    kd8, vd8 = to_e4m3(kd), to_e4m3(vd)
    qd, kn, vn = randn(1, 1, HQ, D), randn(1, KVH, D), randn(1, KVH, D)
    dlens = [torch.full((1,), KVL + j, **i32) for j in range(31)]
    len6 = torch.full((1,), KVL + 1, **i32)
    step = iter(range(10**9))

    def k3(k, v):
        i = next(step)
        return da.flash_decode_stacked(qd, k, v, dlens[i % len(dlens)], i % L, kn, vn)

    def k6():
        i = next(step) % L
        return da.flash_decode(qd, kd[i], vd[i], len6)

    cases = {
        "K1": lambda: fa.packed_qkv_norm_attention(qkv, num_heads=H, q_gamma=qg, k_gamma=kg, eps=1e-6,
                                                   valid_len=VALID),
        "K5": lambda: fa.packed_self_attention(q5, k5, v5, num_heads=H, valid_len=VALID),
        "K2": lambda: fa.flash_attention(q2, k2, v2, causal=True, q_offset=off1, kv_len=len1, kv_format="bntd"),
        "K2 e4m3": lambda: fa.flash_attention(q2, k8, v8, causal=True, q_offset=off1, kv_len=len1,
                                              kv_format="bntd"),
        "K2 batched": lambda: fa.flash_attention(qb, kb, vb, causal=True, q_offset=offb, kv_len=lenb,
                                                 kv_format="bntd"),
        "K14": lambda: pa.paged_flash_prefill(qc, kp, vp, lenc, tables, offc),
        "K16a llm": lambda: fb.flash_fwd(qt, kt, vt, True),
        "K16a vit": lambda: fb.flash_fwd(qv, kv, vv, False),
        "K16a packed": lambda: fb.flash_fwd(qp, kp4, vp4, True, seg),
        **{f"K16b {case}": functools.partial(fb.flash_bwd_dq, *a[:8], **a[8]) for case, a in bwd.items()},
        **{f"K16c {case}": functools.partial(fb.flash_bwd_dkv, *a[:8], **a[8]) for case, a in bwd.items()},
        "K3 eager": lambda: k3(kd, vd),
        "K3_e4m3 eager": lambda: k3(kd8, vd8),
        "K6 eager": k6,
        "K12 eager": lambda: k12(kpool, vpool),
        "K12_e4m3 eager": lambda: k12(kpool8, vpool8),
        "K13 eager": lambda: k13(kpool, vpool),
        "K13_e4m3 eager": lambda: k13(kpool8, vpool8),
    }
    graphs = {name.split()[0]: name for name in cases if name.endswith(" eager")}

    def k13_at(rows):  # K13 with its chunks set to `rows` rows, captured while the split is patched
        name = "paged_splits" if hasattr(pa, "paged_splits") else "manual_splits"  # a tree before K12 took it
        saved = getattr(pa, name)
        setattr(pa, name, lambda B, KVH, cap, sms: (-(-cap // rows), rows))
        try:
            return graphed(lambda: k13(kpool, vpool), L)
        finally:
            setattr(pa, name, saved)

    def time_ms(fn):
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(LAUNCHES):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / LAUNCHES

    def sha(out) -> str:
        h = hashlib.sha256()
        for t in out if isinstance(out, tuple) else (out,):
            h.update(t.contiguous().view(torch.int16 if t.element_size() == 2 else torch.int32).cpu().numpy().tobytes())
        return h.hexdigest()

    digests = {case: sha(fn()) for case, fn in cases.items() if case.startswith("K16")}
    cases.update({name: graphed(cases[eager], L) for name, eager in graphs.items()})
    for rows in filter(None, args.k13_rows.split(",")):
        graphs[f"K13 rows={rows}"] = None
        cases[f"K13 rows={rows}"] = k13_at(int(rows))
    cases = {case: fn for case, fn in cases.items() if case.startswith(tuple(args.cases.split(",")))}
    readings = {case: [] for case in cases}
    for _ in range(READINGS):
        for case, fn in cases.items():
            readings[case].append(time_ms(fn) / (L if case in graphs else 1))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(json.dumps({"card": smi.stdout.strip(), "label": args.label,
                      "ms": {k: sorted(r)[len(r) // 2] for k, r in readings.items()},
                      "sha256": {k: v for k, v in digests.items() if k in cases},
                      "readings": {k: [round(x, 4) for x in r] for k, r in readings.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
