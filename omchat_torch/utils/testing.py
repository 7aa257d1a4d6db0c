"""Shared test/benchmark doubles.

Import-safe from the CPU test suite and from ``chip_smoke.py``: this module
imports nothing but the standard library.
"""


class MockTokenizer:
    """Deterministic byte-level tokenizer implementing the subset of the HF
    tokenizer API the prompt code touches: ``encode``, ``__call__().input_ids``,
    ``decode``, ``bos_token_id``.  Ids are byte values (0-255), far below the
    hardcoded ChatML ids, so sentinel/special-id placement is unambiguous."""

    bos_token_id = None
    eos_token_id = 151645

    def encode(self, text):
        return list(text.encode("utf-8"))

    def __call__(self, text):
        class _Out:
            def __init__(self, ids):
                self.input_ids = ids

        return _Out(self.encode(text))

    all_special_ids = ()

    def __len__(self):
        return 256

    def decode(self, ids, **kw):
        return bytes(int(i) for i in ids if 0 <= int(i) < 256).decode("utf-8", errors="replace")

    def batch_decode(self, seqs, **kw):
        return [self.decode(s) for s in seqs]
