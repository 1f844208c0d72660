"""Inputs made from the seed: the tokenizer, prompts, images and pairs.

No tokenizer files are in the repository, so prompts are words of a seeded
vocabulary and each word is one token: a table of the benchmark's own maps
word ``w<k>`` to an id inside the published vocabulary, and the chat tokens
to their published ids. Both sides tokenize with this one table.

Every seed draws the same multiset of sizes: the traffic file's image sizes
in equal numbers and its prompt lengths evenly spread over their range, with
pixels and words that the seed picks; evaluation's rows come in the seed's
order, serving's requests in one order for every seed.
"""

from __future__ import annotations

import io
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import numpy as np

WORDS = 4096  # distinct prompt words


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *tags])


class WordTokenizer:
    """``tokenizer(text)['input_ids']``: whitespace-split words, ``w<k>`` and
    the chat tokens by table; ``apply_chat_template`` renders the family's
    published template (``chat_template`` in ``benchmark/families/``) with
    the chat tokens as words of their own, at the lengths the port's dataset
    layer slices (Phi-3's 22-character assistant cue; Qwen's 58-character
    system preamble and 23-character cue)."""

    def __init__(self, family: str, tokens: dict, vocab_size: int, seed: int):
        self.family = family
        self.special: Dict[str, int] = dict(tokens["special"])
        self.eos_token = tokens["eos"]
        lo, hi = min(1000, vocab_size // 4), min(vocab_size, 32000)
        free = np.setdiff1d(np.arange(lo, hi), list(self.special.values()))
        ids = rng(seed, 7).choice(free, WORDS, replace=len(free) < WORDS)
        self.table = {f"w{k}": int(i) for k, i in enumerate(ids)}

    def __call__(self, text: str) -> dict:
        return {"input_ids": [self.special[w] if w in self.special else self.table[w]
                              for w in text.split()]}

    def apply_chat_template(self, msgs, tokenize=False, add_generation_prompt=True):
        from . import family

        return family.load(self.family).chat_template(msgs[0]["content"])


@dataclass(frozen=True)
class Image:
    key: int  # index in the pool
    width: int
    height: int


def prompts(seed: int, n: int, lo: int, hi: int) -> List[str]:
    """``n`` prompts of ``lo``..``hi`` words, the lengths spread evenly."""
    r = rng(seed, 1)
    lens = np.linspace(lo, hi, n).round().astype(int)
    r.shuffle(lens)
    return [" ".join(f"w{k}" for k in r.integers(0, WORDS, int(m))) for m in lens]


def image_pool(sizes: Sequence[Sequence[int]], per_size: int) -> List[Image]:
    """``per_size`` images of each size; their pixels come from the seed."""
    return [Image(k, int(w), int(h))
            for k, (w, h) in enumerate(s for s in sizes for _ in range(per_size))]


def pairs(seed: int, pool: List[Image], n: int) -> List[Tuple[int, int]]:
    """``n`` (chosen, rejected) pool indices: every image the same number of
    times over both sides, a fixed multiset, in the seed's order."""
    r = rng(seed, 2)
    keys = np.resize(np.arange(len(pool)), 2 * n)
    r.shuffle(keys)
    out = [(int(keys[2 * i]), int(keys[2 * i + 1])) for i in range(n)]
    return [(a, b if b != a else (b + 1) % len(pool)) for a, b in out]


def pixels(seed: int, img: Image) -> np.ndarray:
    """(h, w, 3) uint8: blocky seeded noise, upsampled, with fine noise on top,
    so that the image has structure at every scale and stays compressible."""
    from PIL import Image as PILImage

    r = rng(seed, 3, img.key)
    h, w = img.height, img.width
    base = r.integers(0, 256, (max(h // 16, 1), max(w // 16, 1), 3), dtype=np.uint8)
    up = np.asarray(PILImage.fromarray(base).resize((w, h), PILImage.BILINEAR))
    return up ^ r.integers(0, 16, (h, w, 3), dtype=np.uint8)


def png_bytes(arr: np.ndarray) -> bytes:
    from PIL import Image as PILImage

    buf = io.BytesIO()
    PILImage.fromarray(arr).save(buf, format="PNG", compress_level=1)
    return buf.getvalue()


def render(family_name: str, tokenizer, prompt: str) -> str:
    """The prompt as the port's dataset layer renders it (the family's
    ``render``)."""
    from . import family

    return family.load(family_name).render(tokenizer, prompt)


def balanced_requests(seed: int, n_sizes: int, per_size: int, blocks: int, lo: int, hi: int
                      ) -> List[Tuple[int, int, str]]:
    """``blocks`` blocks of ``n_sizes`` (chosen, rejected, prompt) requests:
    in each block the chosen images take every size once, the rejected ones
    too, and the prompt lengths spread evenly over ``lo``..``hi``. The order of
    sizes and lengths is the same for every seed (a tail latency depends on
    which requests share a device call); the seed picks the images of a size,
    their pixels and the words."""
    fixed, r = rng(0, 4), rng(seed, 4)
    edges = np.linspace(lo, hi, n_sizes + 1)
    out = []
    for _ in range(blocks):
        ca, rj = fixed.permutation(n_sizes), fixed.permutation(n_sizes)
        lens = fixed.permutation([int(fixed.integers(int(a), int(b) + 1))
                                  for a, b in zip(edges[:-1], edges[1:])])
        for s_c, s_r, m in zip(ca, rj, lens):
            a = int(s_c) * per_size + int(r.integers(per_size))
            b = int(s_r) * per_size + int(r.integers(per_size))
            if a == b:
                b = int(s_r) * per_size + (b % per_size + 1) % per_size
            out.append((a, b, " ".join(f"w{k}" for k in r.integers(0, WORDS, int(m)))))
    return out
