"""Benchmark-eval harness — PyTorch port of ``omchat_tpu/eval/harness.py``,
the working replacement for the reference's ``eval_q.sh`` (it drives
``omchat.eval.{scienceqa,textvqa,gqa,seed_bench,ai2d,okvqa}`` modules that
were never shipped).

Each workload is an (eval → score) pair over a local dataset dump, exactly the
shape eval_q.sh scripts expect: a JSONL of questions with image paths, model
answers written to JSONL, then a scorer.  Dataset files are the common public
dump formats (LLaVA-style ``question_file`` JSONL).

The serial loops (:func:`run_eval`, :func:`run_eval_mantis`,
:func:`run_eval_video`) drive the port's ``OmChatModel.chat`` /
``chat_video``; :func:`run_eval_concurrent` the port's
:class:`~omchat_torch.runtime.paged_engine.PagedBatchEngine`;
:func:`perplexity` the training loss path
(:func:`omchat_torch.training.train_step.loss_fn`) on the engine's attention
route (kernel K2 on CUDA).  The scorers are the JAX package's, line for line.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

from PIL import Image


@dataclass
class EvalSample:
    question_id: str
    text: str
    image_path: Optional[str] = None
    answer: Optional[str] = None  # ground truth (scorers may use other fields)
    extra: Optional[dict] = None
    image_paths: Optional[List[str]] = None  # multi-image (Mantis-Eval)
    video_path: Optional[str] = None  # video (MMBench-Video)


def read_question_file(path: str, image_root: str = "") -> List[EvalSample]:
    """LLaVA-style JSONL: {question_id, text, image, ...}."""
    samples = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            img = d.get("image")
            samples.append(
                EvalSample(
                    question_id=str(d.get("question_id", len(samples))),
                    text=d.get("text") or d.get("question") or "",
                    image_path=os.path.join(image_root, img) if img else None,
                    answer=d.get("answer"),
                    extra=d,
                )
            )
    return samples


def run_eval(
    model,
    samples: Iterable[EvalSample],
    answers_file: str,
    *,
    max_new_tokens: int = 128,
    progress: bool = True,
    guided_choices: Optional[List[str]] = None,
) -> None:
    """Generate an answer per sample and write the answers JSONL.

    ``model`` is an :class:`omchat_torch.api.OmChatModel`.

    ``guided_choices`` constrains every answer to one of the given strings
    (trie-masked decoding) — for MC protocols this removes the free-form
    letter-extraction failure mode entirely."""
    from omchat_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=max_new_tokens)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as out:
        for i, s in enumerate(samples):
            image = Image.open(s.image_path).convert("RGB") if s.image_path else None
            answer = model.chat(s.text, image=image, generation=gen, guided_choices=guided_choices)
            out.write(json.dumps({"question_id": s.question_id, "text": answer}) + "\n")
            if progress and i % 20 == 0:
                print(f"[eval] {i} done", flush=True)


def run_eval_concurrent(
    model,
    samples: Iterable[EvalSample],
    answers_file: str,
    *,
    max_new_tokens: int = 128,
    concurrency: int = 8,
    progress: bool = True,
    mode: str = "default",
    num_frames: int = 32,
    max_len: int = 8192,
    page_size: int = 128,
    decode_roll: int = 8,
    engine=None,
) -> None:
    """Greedy eval with ``concurrency`` requests in flight through the
    continuous-batching :class:`~omchat_torch.runtime.paged_engine
    .PagedBatchEngine` (on the model's device and attention route) — the
    serving engine the serial ``model.chat`` loops
    (run_eval/run_eval_mantis/run_eval_video) leave idle.  Answers are
    identical to the serial loop on the CPU (greedy argmax through the same
    plain versions; tests/test_torch_eval.py); on the card the two routes'
    kernels round bf16 at other places, so answers agree up to the first
    step whose top-2 margin is small.  Throughput scales with slot
    occupancy because decode steps amortize the weight stream across
    requests.  Guided/constrained protocols stay serial by design: their
    token masks are host functions of each growing prefix.  A caller-built
    ``engine`` is used as it is: the geometry arguments (``max_len``,
    ``page_size``, ``decode_roll``) are then not checked against it.

    ``mode``: "default" (text + optional single image), "mantis"
    (multi-image interleave), "video" (``num_frames`` uniform samples per
    video).  ``max_len`` bounds prompt+generation per request — raise it
    (and accept the larger page pool) for video workloads beyond 8k tokens.
    """
    from omchat_torch.config import GenerationConfig
    from omchat_torch.runtime.paged_engine import PagedBatchEngine

    gen = GenerationConfig(max_new_tokens=max_new_tokens)
    if engine is None:
        # Callers running several eval passes should build one engine and
        # pass it in: each call allocates its page pool anew.
        engine = PagedBatchEngine(
            model.config,
            model.engine.params,
            max_slots=concurrency,
            num_pages=concurrency * (max_len // page_size) + 8,
            page_size=page_size,
            max_len=max_len,
            attn_impl=model.engine.attn_impl,
            device=model.engine.device,
            decode_roll=decode_roll,
            prefill_chunk=4096 if max_len >= 4096 else max(512, page_size),
        )

    def build(s: EvalSample):
        if mode == "video":
            from omchat_torch.processing.chat import make_context
            from omchat_torch.processing.video import (
                load_video_frames,
                process_video_frames,
                video_prompt,
            )

            frames = load_video_frames(s.video_path, num_samples=num_frames)
            pixels = process_video_frames(
                frames, tile_size=model.config.vision.image_size, num_samples=num_frames
            )
            prompt = video_prompt(s.text, pixels.shape[0])
            _, ids = make_context(
                model.tokenizer, prompt, None, "You are a helpful assistant."
            )
            return ids, pixels
        if mode == "mantis":
            images = [Image.open(p).convert("RGB") for p in (s.image_paths or [])]
            inputs = model.processor(s.text, images=images or None)
        else:
            image = Image.open(s.image_path).convert("RGB") if s.image_path else None
            inputs = model.processor(s.text, images=image)
        return inputs["input_ids"][0].tolist(), inputs.get("images")

    samples = list(samples)
    results: Dict[str, str] = {}
    inflight: Dict[int, EvalSample] = {}
    it = iter(samples)
    exhausted = False
    while len(results) < len(samples):
        while not exhausted and len(inflight) < concurrency:
            s = next(it, None)
            if s is None:
                exhausted = True
                break
            ids, imgs = build(s)
            rid = engine.submit(
                list(ids), imgs, max_new_tokens=max_new_tokens,
                eos_token_id=gen.eos_token_id,
            )
            inflight[rid] = s
        engine.step()
        for rid in [r for r in list(inflight) if engine.finished(r)]:
            toks, _ = engine.pop_result(rid)
            s = inflight.pop(rid)
            results[s.question_id] = model.tokenizer.decode(toks, skip_special_tokens=True)
            if progress and len(results) % 20 == 0:
                print(f"[eval x{concurrency}] {len(results)}/{len(samples)} done", flush=True)

    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as out:
        for s in samples:
            rec = {"question_id": s.question_id, "text": results[s.question_id]}
            if mode == "mantis":
                rec["question_type"] = (s.extra or {}).get("question_type", "multi-choice")
            out.write(json.dumps(rec) + "\n")


def perplexity(model, text: str, *, window: int = 2048) -> dict:
    """Teacher-forced perplexity of ``text`` under the loaded model.

    Non-overlapping windows of ``window`` tokens (the simple protocol; each
    window conditions only on itself, so the number is slightly pessimistic
    vs a sliding window — stated in the result).  Reuses the training loss
    path (train_step.loss_fn) without gradients, on the engine's device and
    attention route (``attn_impl=None``: kernel K2 on CUDA; ``"plain"``: the
    plain reference attention), so int8-quantized params evaluate through
    the same kernels they serve with.

    Returns {"perplexity", "nll", "tokens", "windows", "protocol"}.
    """
    import numpy as np
    import torch

    from omchat_torch.constants import IGNORE_INDEX
    from omchat_torch.models.omchat import plan_multimodal_merge
    from omchat_torch.training.train_step import loss_fn

    ids = model.tokenizer.encode(text)
    if len(ids) < 2:
        raise ValueError("need at least 2 tokens for perplexity")
    engine = model.engine
    total_nll, total_tokens, windows = 0.0, 0, 0
    for w0 in range(0, len(ids) - 1, window):
        chunk = ids[w0 : w0 + window + 1]
        if len(chunk) < 2:
            break
        plan = plan_multimodal_merge([chunk], model.config.image_seq_len, bucket=128)
        labels = np.full_like(plan.token_ids, IGNORE_INDEX)
        n = len(chunk)
        # loss_fn shifts labels left internally; expose every next-token
        # target except the window's first token (unconditioned)
        labels[0, 1:n] = plan.token_ids[0, 1:n]
        batch = {
            "token_ids": torch.as_tensor(plan.token_ids, device=engine.device),
            "is_image": torch.as_tensor(plan.is_image, device=engine.device),
            "image_index": torch.as_tensor(plan.image_index, device=engine.device),
            "positions": torch.as_tensor(plan.positions, device=engine.device),
            "labels": torch.as_tensor(labels, device=engine.device),
        }
        with torch.no_grad():
            loss, n_valid = loss_fn(
                engine.params, model.config, batch, attn_impl=engine.attn_impl, remat=False
            )
        total_nll += float(loss) * int(n_valid)
        total_tokens += int(n_valid)
        windows += 1
    nll = total_nll / max(1, total_tokens)
    import math

    return {
        "perplexity": math.exp(nll),
        "nll": nll,
        "tokens": total_tokens,
        "windows": windows,
        "protocol": f"non-overlapping {window}-token windows, teacher-forced",
    }


# ---------------------------------------------------------------------------
# Scorers (answer-matching protocols of the eval_q.sh workloads)
# ---------------------------------------------------------------------------


def _norm(s: str) -> str:
    return re.sub(r"[^a-z0-9 ]", "", s.lower()).strip()


def extract_choice(answer: str) -> Optional[str]:
    """Pull a multiple-choice letter (A-E) out of a free-form answer."""
    m = re.search(r"\b([A-E])\b", answer.strip().upper())
    return m.group(1) if m else None


def score_multiple_choice(answers: Dict[str, str], truths: Dict[str, str]) -> float:
    """ScienceQA / SEED-Bench / AI2D protocol: exact choice-letter match."""
    correct = sum(
        1 for qid, ans in answers.items() if extract_choice(ans) == str(truths.get(qid, "")).upper()
    )
    return correct / max(len(answers), 1)


def score_exact_match(answers: Dict[str, str], truths: Dict[str, str]) -> float:
    """GQA protocol: normalized exact match."""
    correct = sum(1 for qid, ans in answers.items() if _norm(ans) == _norm(str(truths.get(qid, ""))))
    return correct / max(len(answers), 1)


def vqa_accuracy(answer: str, gt_answers: List[str]) -> float:
    """VQA-v2 consensus metric (TextVQA / OKVQA): min(#matches/3, 1)."""
    a = _norm(answer)
    matches = sum(1 for gt in gt_answers if _norm(gt) == a)
    return min(matches / 3.0, 1.0)


def score_vqa(answers: Dict[str, str], truths: Dict[str, List[str]]) -> float:
    scores = [vqa_accuracy(ans, truths.get(qid, [])) for qid, ans in answers.items()]
    return sum(scores) / max(len(scores), 1)


# ---------------------------------------------------------------------------
# Mantis-Eval (multi-image interleave) — the reference's headline multi-image
# benchmark (the reference README.md:105-107).
# ---------------------------------------------------------------------------

MC_INSTRUCTION = "Answer with the option's letter from the given choices directly."
SA_INSTRUCTION = "Answer the question using a single word or phrase."


def read_mantis_file(path: str, image_root: str = "") -> List[EvalSample]:
    """Mantis-Eval local dump (one JSON object per line, the TIGER-Lab/
    Mantis-Eval record shape): ``{question_id, question, images: [paths],
    question_type: "multi-choice"|"short-answer", options: [...], answer}``.

    ``question`` may carry explicit ``<image>`` interleave markers; when it
    has fewer markers than images, the missing ones are prepended (the
    standard Mantis harness behavior)."""
    from omchat_torch.constants import DEFAULT_IMAGE_TOKEN

    samples = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            q = d.get("question") or d.get("text") or ""
            imgs = d.get("images") or ([d["image"]] if d.get("image") else [])
            missing = len(imgs) - q.count(DEFAULT_IMAGE_TOKEN)
            if missing > 0:
                q = "\n".join([DEFAULT_IMAGE_TOKEN] * missing + [q])
            qtype = d.get("question_type", "multi-choice")
            options = d.get("options") or []
            if qtype.startswith("multi") and options:
                # options may already carry "A. ..." prefixes; add when absent
                lines = [
                    o if re.match(r"^\s*\(?[A-E][.):]", o) else f"{chr(65 + i)}. {o}"
                    for i, o in enumerate(options)
                ]
                q = q + "\n" + "\n".join(lines) + "\n" + MC_INSTRUCTION
            elif not qtype.startswith("multi"):
                q = q + "\n" + SA_INSTRUCTION
            samples.append(
                EvalSample(
                    question_id=str(d.get("question_id", d.get("id", len(samples)))),
                    text=q,
                    image_paths=[os.path.join(image_root, p) for p in imgs],
                    answer=str(d.get("answer", "")),
                    extra={"question_type": qtype},
                )
            )
    return samples


def run_eval_mantis(
    model,
    samples: Iterable[EvalSample],
    answers_file: str,
    *,
    max_new_tokens: int = 64,
    progress: bool = True,
    guided_mc: bool = False,
) -> None:
    """Multi-image interleaved generation per Mantis-Eval sample.

    Each sample's images feed the anyres processor; the prompt interleaves
    per-image tile expansions at the ``<image>`` markers
    (processing/chat.py::interleave_image_prompt).  ``guided_mc`` constrains
    multi-choice answers to the option letters via trie-masked decoding."""
    from omchat_torch.config import GenerationConfig

    gen = GenerationConfig(max_new_tokens=max_new_tokens)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as out:
        for i, s in enumerate(samples):
            images = [Image.open(p).convert("RGB") for p in (s.image_paths or [])]
            qtype = (s.extra or {}).get("question_type", "multi-choice")
            guided = list("ABCDE") if (guided_mc and qtype.startswith("multi")) else None
            answer = model.chat(s.text, image=images or None, generation=gen,
                                guided_choices=guided)
            out.write(json.dumps({"question_id": s.question_id, "text": answer,
                                  "question_type": qtype}) + "\n")
            if progress and i % 20 == 0:
                print(f"[mantis] {i} done", flush=True)


def score_mantis(answers: Dict[str, str], truths: Dict[str, dict]) -> Dict[str, float]:
    """Mantis-Eval accuracy: choice-letter match for multi-choice questions,
    normalized exact match for short-answer.  ``truths[qid]`` is
    ``{"answer": str, "question_type": str}``.  Returns overall + per-type."""
    per_type: Dict[str, List[float]] = {"multi-choice": [], "short-answer": []}
    for qid, ans in answers.items():
        t = truths.get(qid)
        if t is None:
            continue
        qtype = "multi-choice" if t.get("question_type", "").startswith("multi") else "short-answer"
        if qtype == "multi-choice":
            ok = extract_choice(ans) == str(t["answer"]).strip().upper()
        else:
            ok = _norm(ans) == _norm(str(t["answer"]))
        per_type[qtype].append(1.0 if ok else 0.0)
    scored = [v for vs in per_type.values() for v in vs]
    out = {"overall": sum(scored) / max(len(scored), 1)}
    for k, vs in per_type.items():
        if vs:
            out[k] = sum(vs) / len(vs)
    return out


# ---------------------------------------------------------------------------
# MMBench-Video (32-frame video QA) — the reference's headline video benchmark
# (the reference README.md:187-200).
# ---------------------------------------------------------------------------

# L2 capability dimensions → L1 groups, exactly the README table's columns
# (Perception: CP, FP-S, FP-C, HL; Reasoning: LR, AR, RR, CSR, TR).
MMBENCH_VIDEO_L1: Dict[str, str] = {
    "CP": "Perception", "FP-S": "Perception", "FP-C": "Perception", "HL": "Perception",
    "LR": "Reasoning", "AR": "Reasoning", "RR": "Reasoning", "CSR": "Reasoning",
    "TR": "Reasoning",
}


def read_video_question_file(path: str, video_root: str = "") -> List[EvalSample]:
    """MMBench-Video local dump JSONL: ``{question_id, video, question,
    answer, dimensions: ["<L3 name>", ...], l2: "CP"|...}``.  ``video`` is a
    path readable by processing/video.py::load_video_frames (frame directory,
    animated image, or container)."""
    samples = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            d = json.loads(line)
            samples.append(
                EvalSample(
                    question_id=str(d.get("question_id", d.get("index", len(samples)))),
                    text=d.get("question") or d.get("text") or "",
                    video_path=os.path.join(video_root, d["video"]) if d.get("video") else None,
                    answer=str(d.get("answer", "")),
                    extra={"dimensions": d.get("dimensions") or [], "l2": d.get("l2")},
                )
            )
    return samples


def run_eval_video(
    model,
    samples: Iterable[EvalSample],
    answers_file: str,
    *,
    num_frames: int = 32,
    max_new_tokens: int = 128,
    progress: bool = True,
) -> None:
    """MMBench-Video generation: uniform ``num_frames`` sampling per video
    (the reference's 32-frame configuration), one ViT tile + sentinel per
    frame through OmChatModel.chat_video."""
    from omchat_torch.config import GenerationConfig
    from omchat_torch.processing.video import load_video_frames

    gen = GenerationConfig(max_new_tokens=max_new_tokens)
    os.makedirs(os.path.dirname(os.path.abspath(answers_file)), exist_ok=True)
    with open(answers_file, "w") as out:
        for i, s in enumerate(samples):
            frames = load_video_frames(s.video_path, num_samples=num_frames)
            answer = model.chat_video(s.text, frames, num_samples=num_frames, generation=gen)
            out.write(json.dumps({"question_id": s.question_id, "text": answer}) + "\n")
            if progress and i % 5 == 0:
                print(f"[mmbench_video] {i} done", flush=True)


def _stem(w: str) -> str:
    """Light suffix stripping so inflection doesn't break recall matching
    ('rides'/'riding' ≡ 'ride').  Deliberately tiny — no Porter machinery."""
    for suf in ("ing", "ed", "es", "s"):
        if w.endswith(suf) and len(w) - len(suf) >= 3:
            return w[: -len(suf)]
    return w


def _word_match(tw: str, answer_words: List[str]) -> bool:
    # equal stems, or stems differing by a dropped final 'e' ('riding' → 'rid'
    # vs 'rides' → 'ride'); no prefix matching — 'cat' must not hit 'catches'
    ts = _stem(tw)
    return any(
        aw == tw or _stem(aw) == ts or _stem(aw) + "e" == ts or ts + "e" == _stem(aw)
        for aw in answer_words
    )


def judge_answer_heuristic(answer: str, truth: str) -> int:
    """Offline 0-3 judge standing in for MMBench-Video's GPT judge (an eval
    run makes no network call).  Content-word recall (stemmed) against the
    ground truth: 3 = exact/containment match, 2 = full recall, 1 = ≥half
    recall, 0 otherwise.  Validated against the hand-labeled fixture of
    tests/test_eval_harness.py (exact / ±1 agreement pinned there); its
    scores are NOT
    comparable to the reference's GPT-judge numbers — for official numbers
    pass GPT-judge scores via ``score_mmbench_video(..., scores=...)``."""
    a, t = _norm(answer), _norm(truth)
    if not t:
        return 0
    if a == t or (len(t) > 3 and t in a):
        return 3
    words = [w for w in t.split() if len(w) > 2]
    a_words = a.split()
    if not words:
        return 3 if t in a_words else 0
    recall = sum(1 for w in words if _word_match(w, a_words)) / len(words)
    if recall >= 1.0:
        return 2
    if recall >= 0.5:
        return 1
    return 0


def score_mmbench_video(
    answers: Dict[str, str],
    samples: List[EvalSample],
    scores: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """The MMBench-Video 3-level mean protocol over 0-3 question scores:

    1. per-question score (external GPT-judge ``scores`` if given, else the
       offline heuristic judge),
    2. mean per L2 capability dimension (CP/FP-S/FP-C/HL/LR/AR/RR/CSR/TR),
    3. L1 means (Perception, Reasoning) as the mean of their member L2 means,
       and the overall mean as the mean of all L2 means — the README table's
       column structure (README.md:187-200).

    Questions without an L2 tag contribute only to a flat ``question_mean``.
    Returns {"overall", "Perception", "Reasoning", <each L2>, "question_mean"}.
    """
    by_qid = {s.question_id: s for s in samples}
    q_scores: List[float] = []
    l2_scores: Dict[str, List[float]] = {}
    for qid, ans in answers.items():
        s = by_qid.get(qid)
        if s is None:
            continue
        val = float(scores[qid]) if scores and qid in scores else float(
            judge_answer_heuristic(ans, s.answer or "")
        )
        q_scores.append(val)
        l2 = (s.extra or {}).get("l2")
        if l2 in MMBENCH_VIDEO_L1:
            l2_scores.setdefault(l2, []).append(val)
    out: Dict[str, float] = {"question_mean": sum(q_scores) / max(len(q_scores), 1)}
    l1_members: Dict[str, List[float]] = {"Perception": [], "Reasoning": []}
    for l2, vals in sorted(l2_scores.items()):
        mean = sum(vals) / len(vals)
        out[l2] = mean
        l1_members[MMBENCH_VIDEO_L1[l2]].append(mean)
    for l1, means in l1_members.items():
        if means:
            out[l1] = sum(means) / len(means)
    all_l2 = [out[k] for k in l2_scores]
    out["overall"] = sum(all_l2) / len(all_l2) if all_l2 else out["question_mean"]
    return out


# ---------------------------------------------------------------------------
# COCO caption metrics (BLEU-4 / CIDEr-D) — the last sliver of the reference's
# dead eval toolbox (the reference's omchat/model/multimodal_encoder/utils.py:
# 742-913 `coco_caption_eval` wraps pycocoevalcap alongside the VQAScore /
# BeamHypotheses machinery rebuilt elsewhere).  No pycocotools offline, so the
# metrics are implemented directly from their published definitions:
# BLEU (Papineni et al. 2002), CIDEr-D (Vedantam et al. 2015, the
# length-penalized / count-clipped variant the COCO server reports).
# ---------------------------------------------------------------------------


def _caption_ngrams(tokens: List[str], n: int):
    from collections import Counter

    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def _ref_lists(truths: Dict[str, object]) -> Dict[str, List[str]]:
    return {
        qid: ([refs] if isinstance(refs, str) else list(refs))
        for qid, refs in truths.items()
    }


def score_bleu4(answers: Dict[str, str], truths: Dict[str, List[str]]) -> float:
    """Corpus-level BLEU-4: clipped n-gram precision (n=1..4, uniform
    weights), geometric mean, brevity penalty against the closest reference
    length.  ``truths[qid]`` is a list of reference captions (or one str)."""
    import math
    from collections import Counter

    hits = [0] * 4
    totals = [0] * 4
    c_len = r_len = 0
    for qid, ans in answers.items():
        refs = _ref_lists(truths).get(qid) if qid in truths else None
        if not refs:
            continue
        cand = _norm(ans).split()
        rtoks = [_norm(r).split() for r in refs]
        c_len += len(cand)
        # closest reference length (ties break toward the shorter reference)
        r_len += min((abs(len(r) - len(cand)), len(r)) for r in rtoks)[1]
        for n in range(1, 5):
            cng = _caption_ngrams(cand, n)
            if not cng:
                continue
            max_ref: Counter = Counter()
            for r in rtoks:
                for g, c in _caption_ngrams(r, n).items():
                    max_ref[g] = max(max_ref[g], c)
            hits[n - 1] += sum(min(c, max_ref.get(g, 0)) for g, c in cng.items())
            totals[n - 1] += sum(cng.values())
    if any(t == 0 for t in totals) or any(h == 0 for h in hits):
        return 0.0
    log_p = sum(math.log(hits[i] / totals[i]) for i in range(4)) / 4
    bp = 1.0 if c_len > r_len else math.exp(1.0 - r_len / max(c_len, 1))
    return bp * math.exp(log_p)


def score_cider_d(
    answers: Dict[str, str], truths: Dict[str, List[str]], *, sigma: float = 6.0
) -> float:
    """CIDEr-D: tf-idf n-gram cosine (n=1..4) with count clipping and a
    Gaussian length penalty, averaged over references and n, ×10 — the COCO
    caption server's headline metric.  Document frequency of an n-gram = the
    number of images whose reference set contains it."""
    import math
    from collections import Counter, defaultdict

    refs_by_qid = {qid: v for qid, v in _ref_lists(truths).items() if v}
    qids = [qid for qid in answers if qid in refs_by_qid]
    if not qids:
        return 0.0
    # document frequency over the FULL reference corpus (all images in
    # ``truths``), so idf stays meaningful when only a subset is answered
    df: Dict[tuple, int] = defaultdict(int)
    ref_tok = {
        qid: [_norm(r).split() for r in refs] for qid, refs in refs_by_qid.items()
    }
    for refs in ref_tok.values():
        seen = set()
        for r in refs:
            for n in range(1, 5):
                seen.update(_caption_ngrams(r, n))
        for g in seen:
            df[g] += 1
    log_n_images = math.log(max(len(ref_tok), 1))

    def tfidf_vec(tokens):
        vecs = [Counter() for _ in range(4)]
        norms = [0.0] * 4
        for n in range(1, 5):
            for g, tf in _caption_ngrams(tokens, n).items():
                w = tf * (log_n_images - math.log(max(1.0, df[g])))
                vecs[n - 1][g] = w
                norms[n - 1] += w * w
        return vecs, [math.sqrt(x) for x in norms], len(tokens)

    total = 0.0
    for qid in qids:
        c_vec, c_norm, c_len = tfidf_vec(_norm(answers[qid]).split())
        per_n = [0.0] * 4
        for r in ref_tok[qid]:
            r_vec, r_norm, r_len = tfidf_vec(r)
            penalty = math.exp(-((c_len - r_len) ** 2) / (2 * sigma**2))
            for n in range(4):
                if c_norm[n] == 0.0 or r_norm[n] == 0.0:
                    continue
                num = sum(
                    min(w, r_vec[n].get(g, 0.0)) * r_vec[n].get(g, 0.0)
                    for g, w in c_vec[n].items()
                )
                per_n[n] += penalty * num / (c_norm[n] * r_norm[n])
        m = len(ref_tok[qid])
        total += 10.0 * sum(per_n) / 4.0 / m
    return total / len(qids)


def score_coco_captions(
    answers: Dict[str, str], truths: Dict[str, List[str]]
) -> Dict[str, float]:
    """COCO caption protocol: {"CIDEr-D", "BLEU-4"} over
    ``truths[qid] -> [reference captions]``."""
    return {
        "CIDEr-D": score_cider_d(answers, truths),
        "BLEU-4": score_bleu4(answers, truths),
    }


SCORERS: Dict[str, Callable] = {
    "scienceqa": score_multiple_choice,
    "seed_bench": score_multiple_choice,
    "ai2d": score_multiple_choice,
    "gqa": score_exact_match,
    "textvqa": score_vqa,
    "okvqa": score_vqa,
    "mantis": score_mantis,
    "mmbench_video": score_mmbench_video,
    "coco_caption": score_coco_captions,
}


def read_answers_file(path: str) -> Dict[str, str]:
    out = {}
    with open(path) as f:
        for line in f:
            if line.strip():
                d = json.loads(line)
                out[str(d["question_id"])] = d["text"]
    return out


def score(benchmark: str, answers_file: str, truths: Dict) -> float:
    return SCORERS[benchmark](read_answers_file(answers_file), truths)
