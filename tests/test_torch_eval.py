"""The port's eval harness (``omchat_torch/eval/harness.py``) and eval CLI
(``omchat_torch/cli/eval.py``) on the CPU against the JAX package's: every
reader and scorer on ``tests/test_eval_harness.py``'s fixtures, equal
results, parametrised; the serial loops' answers equal to the JAX loops' on
the same ``OmChatConfig.tiny()`` float32 weights and the ``MockTokenizer``
(text, a single image, multi-image, video); ``run_eval_concurrent`` (the
port's paged engine) byte-identical to the serial answers; perplexity
within 1e-4 of the JAX harness's; ``python -m omchat_torch.cli.eval`` end to
end with ``--device cpu`` on a tiny checkpoint, its usage errors before any
weight loads.
"""

import json

import numpy as np
import pytest
from PIL import Image

import jax

from omchat_torch.api import omchat_model
from omchat_torch.checkpoint.convert import from_jax_params
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.eval import harness as th
from omchat_torch.runtime.generate import OmChatEngine as TEngine
from omchat_torch.utils.testing import MockTokenizer
from tests import test_eval_harness as jt

PPL_TOL = 1e-4  # relative, fp32 on both sides


@pytest.fixture(scope="module")
def models():
    """(the JAX tiny model on XLA attention, the port's over the same weights)."""
    jmodel = jt._tiny_model()
    params = from_jax_params(jax.device_get(jmodel.engine.params))
    return jmodel, omchat_model(MockTokenizer(), TEngine(TOmChatConfig.tiny(), params, device="cpu",
                                                         prompt_bucket=16))


def _scorer_cases():
    samples = [
        ("1", "q", {"l2": "CP"}), ("2", "q", {"l2": "CP"}), ("3", "q", {"l2": "TR"}), ("4", "q", {"l2": "LR"}),
    ]
    captions = {"1": ["a brown dog chases the ball", "a dog runs after a ball"],
                "2": ["two children ride red bicycles downhill"], "3": "an old boat floats near the rocky shore"}
    mantis = {"1": {"answer": "B", "question_type": "multi-choice"},
              "2": {"answer": "C", "question_type": "multi-choice"},
              "3": {"answer": "blue", "question_type": "short-answer"},
              "4": {"answer": "cat", "question_type": "short-answer"}}
    return {
        "extract_choice": ("extract_choice", ["The answer is B.", "(C)", "maybe", "e) last"]),
        "multiple_choice": ("score_multiple_choice", [({"1": "A", "2": "The answer is B", "3": "D."},
                                                       {"1": "A", "2": "B", "3": "C"})]),
        "exact_match": ("score_exact_match", [({"1": "Yes.", "2": "blue"}, {"1": "yes", "2": "red"})]),
        "vqa_accuracy": ("vqa_accuracy", [("cat", ["cat", "cat", "cat", "dog"]), ("cat", ["cat", "dog", "bird"])]),
        "vqa": ("score_vqa", [({"1": "cat", "2": "Dog."}, {"1": ["cat"] * 10, "2": ["dog", "dog", "cat"]})]),
        "mantis": ("score_mantis", [({"1": "The answer is B.", "2": "A", "3": "Blue.", "4": "a dog"}, mantis)]),
        "judge": ("judge_answer_heuristic", [(a, t) for a, t, _ in jt.JUDGE_FIXTURE]),
        "mmbench_video_scores": ("score_mmbench_video", [({"1": "x", "2": "y", "3": "z", "4": "w"}, "samples",
                                                          {"1": 3, "2": 1, "3": 2, "4": 1})]),
        "mmbench_video_judge": ("score_mmbench_video", [({"1": "a red car", "2": "red", "3": "car", "4": "x"},
                                                         "samples", None)]),
        "bleu4": ("score_bleu4", [({"1": "the cat sat on the mat"}, {"1": ["the cat sat on a mat"]}),
                                  ({"1": "a dog runs after the ball", "2": "kids ride bikes"}, captions)]),
        "cider_d": ("score_cider_d", [({"1": "a dog runs after the ball", "2": "kids ride red bicycles"}, captions),
                                      ({"1": "in the park"}, {"1": ["in the park a brown dog barks"],
                                                              "2": ["in the park children fly kites"]})]),
        "coco_captions": ("score_coco_captions", [({"1": "a dog chases a ball", "3": "a boat"}, captions)]),
    }, samples


SCORER_CASES, VIDEO_SAMPLES = _scorer_cases()


@pytest.mark.parametrize("case", list(SCORER_CASES))
def test_scorers_match_jax(case):
    from omchat_tpu.eval import harness as jh

    name, calls = SCORER_CASES[case]
    for args in calls:
        if not isinstance(args, tuple):
            args = (args,)
        jargs, targs = args, args
        if "samples" in args:  # the MMBench-Video scorer reads the samples' L2 tags
            jargs = tuple([jh.EvalSample(q, t, extra=e) for q, t, e in VIDEO_SAMPLES] if a == "samples" else a
                          for a in args)
            targs = tuple([th.EvalSample(q, t, extra=e) for q, t, e in VIDEO_SAMPLES] if a == "samples" else a
                          for a in args)
        assert getattr(th, name)(*targs) == getattr(jh, name)(*jargs), (name, args)
    assert set(th.SCORERS) == set(jh.SCORERS)


def test_readers_match_jax(tmp_path):
    from omchat_tpu.eval import harness as jh

    q = tmp_path / "q.jsonl"
    q.write_text(json.dumps({"question_id": 7, "text": "what?", "image": "a.jpg"}) + "\n\n"
                 + json.dumps({"question_id": 8, "question": "why?", "answer": "so"}) + "\n")
    m = tmp_path / "m.jsonl"
    m.write_text(json.dumps({"id": "m1", "question": "Which is bigger?", "images": ["a.jpg", "b.jpg"],
                             "question_type": "multi-choice", "options": ["the first", "B. the second"],
                             "answer": "A"}) + "\n"
                 + json.dumps({"id": "m2", "question": "<image> then <image>: what changed?",
                               "images": ["c.jpg", "d.jpg"], "question_type": "short-answer",
                               "answer": "the color"}) + "\n")
    v = tmp_path / "v.jsonl"
    v.write_text(json.dumps({"question_id": "v1", "video": "vid1", "question": "What happens?", "answer": "noise",
                             "l2": "TR", "dimensions": ["x"]}) + "\n")
    a = tmp_path / "a.jsonl"
    a.write_text(json.dumps({"question_id": 1, "text": "A"}) + "\n" + json.dumps({"question_id": "2", "text": "b"}))
    fields = lambda s: (s.question_id, s.text, s.image_path, s.answer, s.extra, s.image_paths,  # noqa: E731
                        s.video_path)
    for reader, path in (("read_question_file", q), ("read_mantis_file", m), ("read_video_question_file", v)):
        got = [fields(s) for s in getattr(th, reader)(str(path), "/data")]
        assert got == [fields(s) for s in getattr(jh, reader)(str(path), "/data")], reader
    assert th.read_answers_file(str(a)) == jh.read_answers_file(str(a)) == {"1": "A", "2": "b"}


def _png(path, seed, h=64, w=80):
    Image.fromarray(np.random.default_rng(seed).integers(0, 255, (h, w, 3), dtype=np.uint8)).save(path)
    return str(path)


def _samples(tmp_path, mod):
    img = _png(tmp_path / "x.png", 3)
    return [
        mod.EvalSample(question_id="1", text="what is shown?", image_path=img),
        mod.EvalSample(question_id="2", text="describe the weather today"),
        mod.EvalSample(question_id="3", text="is this a photo?", image_path=img),
        mod.EvalSample(question_id="4", text="count the objects please"),
        mod.EvalSample(question_id="5", text="name one color"),
    ]


def test_serial_answers_match_jax_and_concurrent(models, tmp_path):
    """The port's run_eval writes the JAX run_eval's answers file, and the
    port's run_eval_concurrent (3 slots, page size 64) the same bytes."""
    from omchat_tpu.eval import harness as jh

    jmodel, tmodel = models
    files = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "serial", "concurrent")}
    jh.run_eval(jmodel, _samples(tmp_path, jh), files["jax"], max_new_tokens=6, progress=False)
    th.run_eval(tmodel, _samples(tmp_path, th), files["serial"], max_new_tokens=6, progress=False)
    th.run_eval_concurrent(tmodel, _samples(tmp_path, th), files["concurrent"], max_new_tokens=6, progress=False,
                           concurrency=3, max_len=512, page_size=64)
    text = {k: open(p).read() for k, p in files.items()}
    assert text["serial"] == text["jax"] and text["concurrent"] == text["serial"]
    assert len(text["serial"].splitlines()) == 5


def test_guided_serial_answers_match_jax(models, tmp_path):
    from omchat_tpu.eval import harness as jh

    jmodel, tmodel = models
    out = {}
    for name, mod, model in (("jax", jh, jmodel), ("port", th, tmodel)):
        path = str(tmp_path / f"{name}.jsonl")
        mod.run_eval(model, _samples(tmp_path, mod)[:3], path, max_new_tokens=4, progress=False,
                     guided_choices=["A", "B", "C"])
        out[name] = open(path).read()
    assert out["port"] == out["jax"]
    assert all(json.loads(line)["text"] in ("A", "B", "C") for line in out["port"].splitlines())


def _mantis_file(tmp_path):
    for i, name in enumerate(("a.png", "b.png", "c.png")):
        _png(tmp_path / name, i)
    q = tmp_path / "mantis.jsonl"
    q.write_text(json.dumps({"id": "m1", "question": "Which image is brighter?", "images": ["a.png", "b.png"],
                             "question_type": "multi-choice", "options": ["left", "right"], "answer": "A"}) + "\n"
                 + json.dumps({"id": "m2", "question": "<image> What is shown?", "images": ["c.png"],
                               "question_type": "short-answer", "answer": "noise"}) + "\n")
    return str(q)


def test_mantis_serial_matches_jax_and_concurrent(models, tmp_path):
    from omchat_tpu.eval import harness as jh

    jmodel, tmodel = models
    q = _mantis_file(tmp_path)
    files = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "serial", "concurrent")}
    jh.run_eval_mantis(jmodel, jh.read_mantis_file(q, str(tmp_path)), files["jax"], max_new_tokens=4,
                       progress=False)
    samples = th.read_mantis_file(q, str(tmp_path))
    th.run_eval_mantis(tmodel, samples, files["serial"], max_new_tokens=4, progress=False)
    th.run_eval_concurrent(tmodel, samples, files["concurrent"], max_new_tokens=4, progress=False, mode="mantis",
                           concurrency=2, max_len=512, page_size=64)
    text = {k: open(p).read() for k, p in files.items()}
    assert text["serial"] == text["jax"] and text["concurrent"] == text["serial"]


def test_video_serial_matches_jax_and_concurrent(models, tmp_path):
    from omchat_tpu.eval import harness as jh

    jmodel, tmodel = models
    vdir = tmp_path / "vid1"
    vdir.mkdir()
    for i in range(6):
        _png(vdir / f"frame_{i:03d}.png", 10 + i, 48, 64)
    q = tmp_path / "vq.jsonl"
    q.write_text(json.dumps({"question_id": "v1", "video": "vid1", "question": "What happens in the video?",
                             "answer": "noise", "l2": "TR"}) + "\n")
    files = {k: str(tmp_path / f"{k}.jsonl") for k in ("jax", "serial", "concurrent")}
    jh.run_eval_video(jmodel, jh.read_video_question_file(str(q), str(tmp_path)), files["jax"], num_frames=4,
                      max_new_tokens=4, progress=False)
    samples = th.read_video_question_file(str(q), str(tmp_path))
    th.run_eval_video(tmodel, samples, files["serial"], num_frames=4, max_new_tokens=4, progress=False)
    th.run_eval_concurrent(tmodel, samples, files["concurrent"], max_new_tokens=4, progress=False, mode="video",
                           num_frames=4, concurrency=2, max_len=512, page_size=64)
    text = {k: open(p).read() for k, p in files.items()}
    assert text["serial"] == text["jax"] and text["concurrent"] == text["serial"]


@pytest.mark.parametrize("window", [16, 2048])
def test_perplexity_matches_jax(models, window):
    from omchat_tpu.eval import harness as jh

    jmodel, tmodel = models
    text = "the quick brown fox jumps over the lazy dog, then naps beside the old river bank"
    want = jh.perplexity(jmodel, text, window=window)
    got = th.perplexity(tmodel, text, window=window)
    assert (got["tokens"], got["windows"], got["protocol"]) == (want["tokens"], want["windows"], want["protocol"])
    assert got["windows"] >= (2 if window == 16 else 1)
    np.testing.assert_allclose(got["perplexity"], want["perplexity"], rtol=PPL_TOL)
    np.testing.assert_allclose(got["nll"], want["nll"], rtol=PPL_TOL)
    with pytest.raises(ValueError, match="at least 2 tokens"):
        th.perplexity(tmodel, "a")


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from tests.test_api_e2e import _write_tiny_checkpoint, _write_tiny_tokenizer

    d = tmp_path_factory.mktemp("tiny_ckpt")
    _write_tiny_tokenizer(str(d))
    _write_tiny_checkpoint(str(d))
    return d


@pytest.mark.parametrize("concurrency", [1, 2])
def test_cli_eval_end_to_end_on_the_cpu(tiny_ckpt, tmp_path, capsys, concurrency):
    """``main`` with ``--device cpu``: the answers file, the accuracy line of
    the truths file, the same answers serial and concurrent; then
    ``--perplexity``."""
    from omchat_torch.cli.eval import main

    img = _png(tmp_path / "x.png", 4)
    q = tmp_path / "q.jsonl"
    q.write_text("".join(json.dumps(d) + "\n" for d in (
        {"question_id": 1, "text": "what is this?", "image": img},
        {"question_id": 2, "text": "name a color"},
        {"question_id": 3, "text": "and a number"})))
    truths = tmp_path / "truths.json"
    truths.write_text(json.dumps({"1": "red", "2": "blue", "3": "three"}))
    base = ["--model-path", str(tiny_ckpt), "--device", "cpu", "--max-new-tokens", "4"]
    got = {}
    for n in sorted({1, concurrency}):
        answers = tmp_path / f"answers{n}.jsonl"
        out = main(base + ["--benchmark", "gqa", "--question-file", str(q), "--answers-file", str(answers),
                           "--truths-file", str(truths), "--concurrency", str(n), "--max-len", "1024"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed == out and out["benchmark"] == "gqa" and 0.0 <= out["accuracy"] <= 1.0
        got[n] = th.read_answers_file(str(answers))
        assert set(got[n]) == {"1", "2", "3"}
    assert got[concurrency] == got[1]
    text = tmp_path / "t.txt"
    text.write_text("the quick brown fox jumps over the lazy dog " * 3)
    ppl = main(base + ["--perplexity", str(text), "--ppl-window", "32"])
    assert ppl["metric"] == "perplexity" and np.isfinite(ppl["value"]) and ppl["windows"] >= 2


@pytest.mark.parametrize("flags,message", [
    ([], "--perplexity TEXT_FILE"),
    (["--benchmark", "gqa", "--question-file", "q", "--answers-file", "a", "--concurrency", "2", "--guided-mc"],
     "greedy-only"),
    (["--perplexity", "t.txt", "--tp", "2"], "eval entry point has no --tp"),
])
def test_cli_eval_usage_errors_before_loading(flags, message, capsys, monkeypatch):
    from omchat_torch.cli import eval as tcli

    def no_load(*a, **kw):
        raise AssertionError("weights loaded before the usage error")

    monkeypatch.setattr("omchat_torch.api.load_pretrained_model", no_load)
    with pytest.raises(SystemExit) as e:
        tcli.main(["--model-path", "/nonexistent", "--device", "cpu", *flags])
    assert e.value.code == 2 and message in capsys.readouterr().err
