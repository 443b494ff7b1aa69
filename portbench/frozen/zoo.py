"""What the zoo cell takes from the program's side, frozen here: the
token streams of ``repro_torch/data/synthetic.token_stream`` and the batch
maker of ``repro_torch/launch/train.make_zoo_batch`` (the VLM's stub image
embeddings, 0.01 in bf16), and the stage clock ``chip_smoke.ZooClock``
that times a zoo round's stages through its ``hook=``."""
from __future__ import annotations

import numpy as np
import torch


def token_stream(n_seqs: int, seq_len: int, vocab: int, seed: int):
    """Markov-ish token streams: (tokens, targets = the next token)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, vocab, (n_seqs, seq_len + 1), dtype=np.int64)
    base[:, 2::2] = (base[:, 1:-1:2] + 1) % vocab
    return base[:, :-1].astype(np.int32), base[:, 1:].astype(np.int32)


def zoo_batch(seeds, n_seqs: int, seq_len: int, vocab: int, image,
              device) -> dict:
    """(U, B, ...)-stacked batches, worker u's stream from ``seeds[u]``;
    ``image``: the (B, N, d) stub embeddings every worker's batch holds."""
    toks, tgts = zip(*(token_stream(n_seqs, seq_len, vocab, s)
                       for s in seeds))
    return {"tokens": _to_device(np.stack(toks), device),
            "targets": _to_device(np.stack(tgts), device),
            "image_embeds": image.expand((len(seeds),) + tuple(image.shape))}


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``; to a card through pinned memory and
    without waiting, since a pageable copy drains the card's queue first
    and a round would start on an idle card."""
    t = torch.from_numpy(a)
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class ZooClock:
    """The zoo round's hook: an event where each piece of a stage ends and
    one where the next begins; ``stages()`` sums device ms per stage."""

    def __init__(self):
        self.marks = []

    @staticmethod
    def _event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self):
        self.marks = [("start", None, self._event())]

    def __call__(self, stage, **info):
        end = self._event()
        self.marks.append((stage, end, self._event()))

    def stages(self) -> dict:
        torch.cuda.synchronize()
        out = {}
        for prev, (stage, end, _) in zip(self.marks, self.marks[1:]):
            out[stage] = out.get(stage, 0.0) + prev[2].elapsed_time(end)
        return out
