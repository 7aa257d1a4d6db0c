"""The slot engine's LoRA bank on the CPU against the JAX package
(``tests/test_lora_bank.py::test_mixed_adapter_continuous_batch`` is the
oracle): three concurrent requests under adapters 0 (the base), 1 and 2 in one
port ``BatchEngine`` give the JAX ``BatchEngine``'s greedy tokens with the
same bank, and each its own merged-weights single-request run's; a late
joiner under another adapter leaves a running request's tokens as they are;
an adapter id outside the bank raises.  The bank is ``test_torch_lora_bank``'s:
rank 4 (alpha 8) on q / k / v / o and rank 2 on every projection.
"""

import pytest

from omchat_torch.config import GenerationConfig as TGen
from omchat_torch.config import OmChatConfig as TOmChatConfig
from omchat_torch.runtime.batch_engine import BatchEngine as TBatchEngine
from omchat_torch.runtime.generate import OmChatEngine as TEngine
from omchat_torch.training.lora import merge_lora as t_merge
from tests.test_torch_lora_bank import setup  # noqa: F401 — the shared module fixture

PROMPTS = [[7, 11, 13], [5, 23, 29, 31], [3, 37]]
ADAPTERS = [0, 1, 2]
ENGINE = dict(max_slots=4, max_len=64, chunk_size=16)


def _merged_truth(setup, ids, adapter, gen):  # noqa: F811
    params = setup["tparams"] if adapter == 0 else t_merge(setup["tparams"], setup["tadapters"][adapter - 1])
    return TEngine(TOmChatConfig.tiny(), params, device="cpu", prompt_bucket=8).generate([ids], None, gen).token_ids[0]


def test_mixed_adapter_continuous_batch_matches_jax_and_merged(setup):  # noqa: F811
    from omchat_tpu.config import OmChatConfig
    from omchat_tpu.runtime.batch_engine import BatchEngine

    gen = TGen(max_new_tokens=5, eos_token_id=-1)
    jbe = BatchEngine(OmChatConfig.tiny(), setup["jparams"], attn_impl="xla", lora_bank=setup["jbank"], **ENGINE)
    tbe = TBatchEngine(TOmChatConfig.tiny(), setup["tparams"], device="cpu", lora_bank=setup["tbank"], **ENGINE)
    assert tbe.n_adapters == jbe.n_adapters == 2
    runs = []
    for be in (jbe, tbe):
        rids = [be.submit(ids, None, max_new_tokens=5, eos_token_id=-1, adapter_id=a)
                for ids, a in zip(PROMPTS, ADAPTERS)]
        be.run_to_completion()
        runs.append([be.result(r) for r in rids])
    assert runs[1] == runs[0]
    for got, ids, a in zip(runs[1], PROMPTS, ADAPTERS):
        assert got == _merged_truth(setup, ids, a, gen)
    for be in (jbe, tbe):
        with pytest.raises(ValueError, match="adapter_id"):
            be.submit([1, 2], None, adapter_id=3)
        with pytest.raises(ValueError, match="adapter_id"):
            be.submit([1, 2], None, adapter_id=-1)


def test_late_joiner_under_another_adapter_leaves_tokens(setup):  # noqa: F811
    gen = TGen(max_new_tokens=8, eos_token_id=-1)
    be = TBatchEngine(TOmChatConfig.tiny(), setup["tparams"], device="cpu", lora_bank=setup["tbank"], **ENGINE)
    ra = be.submit(PROMPTS[1], None, max_new_tokens=8, eos_token_id=-1, adapter_id=1)
    for _ in range(3):
        be.step()
    rb = be.submit(PROMPTS[0], None, max_new_tokens=8, eos_token_id=-1, adapter_id=2)
    be.run_to_completion()
    assert be.result(ra) == _merged_truth(setup, PROMPTS[1], 1, gen)
    assert be.result(rb) == _merged_truth(setup, PROMPTS[0], 2, gen)
