"""Reward datasets and blending (the port's own copy of
``llava_reward_tpu/data/datasets.py``).

Reference (llava_reward/datasets/reward_dataset.py, utils/utils.py:120-192):
- pairwise rows {prompt | [prompt_c, prompt_r], chosen_path, reject_path,
  c_rate, r_rate} (reward_dataset.py:11-17);
- pointwise CLS rows {prompt, path, label} (:19-23);
- blending_datasets: local json/jsonl/csv/parquet/txt or HF-hub datasets,
  probability-interleaved.

Items are processed samples; collation pads to a static sequence length.
Image decode and HD geometry run in the loader's worker threads
(``data/loader.py``), overlapped with the card's work. Phi-3.5-vision,
Qwen2.5-VL and LLaVA-NeXT (pairwise; its pointwise rows take the phi3v
dataset, as in the JAX package's registry).
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..preprocess.collate import collate_samples
from ..preprocess.phi3v_processor import Phi3VProcessor, apply_phi3v_chat_template


def load_json_dataset(path: str) -> List[dict]:
    """One local file -> list of row dicts (json/jsonl supported natively;
    csv/parquet/txt via HF datasets if installed)."""
    ext = os.path.splitext(path)[1].lower().lstrip(".")
    if ext == "json":
        with open(path) as f:
            data = json.load(f)
        return list(data)
    if ext == "jsonl":
        with open(path) as f:
            return [json.loads(line) for line in f if line.strip()]
    try:
        from datasets import load_dataset  # HF

        fmt = {"txt": "text"}.get(ext, ext)
        ds = load_dataset(fmt, data_files=path)["train"]
        return [dict(r) for r in ds]
    except ImportError as e:  # pragma: no cover
        raise ValueError(f"unsupported dataset format without hf datasets: {path}") from e


def blending_datasets(
    names: str,
    probs: Optional[str] = None,
    seed: int = 42,
    max_count: int = 2_000_000,
    stopping_strategy: str = "first_exhausted",
    return_eval: bool = True,
    train_split: str = "train",
    eval_split: str = "test",
    train_split_ratio: float = 1.0,
) -> Tuple[List[dict], List[dict]]:
    """Load + probability-interleave multiple datasets
    (utils/utils.py:120-192). ``names`` is comma-separated paths/hub ids;
    ``probs`` comma-separated sampling probabilities."""
    name_list = [n.strip() for n in names.split(",") if n.strip()]
    if probs is None:
        prob_list = [1.0] * len(name_list)
    else:
        prob_list = [float(p) for p in probs.split(",")]
    if len(prob_list) != len(name_list):
        raise ValueError(f"{len(name_list)} datasets but {len(prob_list)} probabilities")

    datasets: List[List[dict]] = []
    for name in name_list:
        if os.path.exists(name):
            if os.path.isdir(name):
                files = sorted(
                    os.path.join(name, f)
                    for f in os.listdir(name)
                    if f.split(".")[-1] in ("json", "jsonl", "csv", "parquet", "txt")
                )
                rows: List[dict] = []
                for f in files:
                    rows.extend(load_json_dataset(f))
            else:
                rows = load_json_dataset(name)
        else:  # HF hub id
            from datasets import load_dataset

            ds = load_dataset(name)
            split = train_split if train_split in ds else list(ds.keys())[0]
            rows = [dict(r) for r in ds[split]]
        datasets.append(rows[:max_count])

    rng = np.random.default_rng(seed)
    total = np.asarray(prob_list, np.float64)
    total = total / total.sum()
    # probability interleave until first_exhausted / all_exhausted
    cursors = [0] * len(datasets)
    out: List[dict] = []
    exhausted = [len(d) == 0 for d in datasets]
    while True:
        if stopping_strategy == "first_exhausted":
            if any(exhausted):
                break
        else:
            if all(exhausted):
                break
        i = int(rng.choice(len(datasets), p=total))
        if cursors[i] >= len(datasets[i]):
            exhausted[i] = True
            if stopping_strategy == "first_exhausted":
                break
            continue
        out.append(datasets[i][cursors[i]])
        cursors[i] += 1
        if cursors[i] >= len(datasets[i]):
            exhausted[i] = True
    train = out
    if not return_eval:
        return train, []
    if train_split_ratio < 1.0:  # --train_split_ratio
        n_train = max(1, int(len(train) * train_split_ratio))
        return train[:n_train], train[n_train:]
    n_eval = max(1, min(len(train) // 20, 1000))
    return train[:-n_eval] or train, train[-n_eval:]


def parse_pairwise_row(row: dict):
    """(reward_dataset.py:11-17)"""
    return (
        row["prompt"],
        row["chosen_path"],
        row["reject_path"],
        row.get("c_rate", 1.0),
        row.get("r_rate", 0.0),
    )


def parse_pointwise_row(row: dict):
    """(reward_dataset.py:19-23)"""
    return row["prompt"], row["path"], row["label"]


def is_pairwise(rows: Sequence[dict]) -> bool:
    """The eval harness sniffs format by key presence
    (batch_inference_rm_phi.py:45-48 checks len(dataset[0])==3)."""
    return "chosen_path" in rows[0]


class PairwiseRewardDataset:
    """Pairwise preference dataset for Phi-3.5-V.

    Each item -> (chosen ProcessedSample, rejected ProcessedSample,
    c_rate, r_rate). Prompt construction matches reward_dataset.py:84-110:
    chat template minus the 22-char assistant cue, EOS appended; a 2-list
    prompt gives chosen/rejected their own prompts.
    """

    def __init__(
        self,
        rows: Sequence[dict],
        processor: Phi3VProcessor,
        tokenizer,
        image_root: Optional[str] = None,
    ):
        self.rows = list(rows)
        self.processor = processor
        self.tokenizer = tokenizer
        self.image_root = image_root

    def __len__(self):
        return len(self.rows)

    def _path(self, p):
        return os.path.join(self.image_root, p) if self.image_root else p

    def _open(self, p):
        # the native fused decode+HD+normalise pipeline reads the file's
        # bytes where it builds; LRT_NATIVE_IMG=0 opts out
        if os.environ.get("LRT_NATIVE_IMG", "1") != "0" and getattr(
            self.processor, "accepts_bytes", False
        ):
            from ..preprocess import native

            if native.native_available():
                with open(self._path(p), "rb") as f:
                    return f.read()
        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True  # (reward_dataset.py:10)
        return Image.open(self._path(p)).convert("RGB")

    def __getitem__(self, idx: int):
        prompt, chosen, reject, c_rate, r_rate = parse_pairwise_row(self.rows[idx])
        if isinstance(prompt, list):
            prompt_c = apply_phi3v_chat_template(self.tokenizer, prompt[0])
            prompt_r = apply_phi3v_chat_template(self.tokenizer, prompt[1])
        else:
            prompt_c = prompt_r = apply_phi3v_chat_template(self.tokenizer, prompt)
        chosen_s = self.processor(prompt_c, [self._open(chosen)])
        reject_s = self.processor(prompt_r, [self._open(reject)])
        return chosen_s, reject_s, float(c_rate), float(r_rate)

    def collate(self, items, seq_len: int, pad_token_id: int):
        chosen = collate_samples([i[0] for i in items], seq_len, pad_token_id)
        rejected = collate_samples([i[1] for i in items], seq_len, pad_token_id)
        c_rate = np.asarray([i[2] for i in items], np.float32)
        r_rate = np.asarray([i[3] for i in items], np.float32)
        return chosen, rejected, c_rate, r_rate


class PointwiseRewardDataset:
    """CLS dataset: item -> (ProcessedSample, label) (reward_dataset.py:119-134)."""

    def __init__(
        self,
        rows: Sequence[dict],
        processor: Phi3VProcessor,
        tokenizer,
        image_root: Optional[str] = None,
    ):
        self.rows = list(rows)
        self.processor = processor
        self.tokenizer = tokenizer
        self.image_root = image_root

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx: int):
        prompt, path, label = parse_pointwise_row(self.rows[idx])
        text = apply_phi3v_chat_template(self.tokenizer, prompt)
        if self.image_root:
            path = os.path.join(self.image_root, path)
        from PIL import Image, ImageFile

        ImageFile.LOAD_TRUNCATED_IMAGES = True
        sample = self.processor(text, [Image.open(path).convert("RGB")])
        return sample, int(label)

    def collate(self, items, seq_len: int, pad_token_id: int):
        batch = collate_samples([i[0] for i in items], seq_len, pad_token_id)
        labels = np.asarray([i[1] for i in items], np.float32)
        return batch, labels


class LlavaPairwiseRewardDataset(PairwiseRewardDataset):
    """LLaVA-v1.6 pairwise dataset (``datasets.py:246-262``; reward_dataset.py:
    267-350): chat template sliced [0:-11] + EOS; the anyres samples collate
    as the phi3v ones do (the f32 bank, full tiles)."""

    def __getitem__(self, idx: int):
        from ..preprocess.llava_processor import apply_llava_chat_template

        prompt, chosen, reject, c_rate, r_rate = parse_pairwise_row(self.rows[idx])
        if isinstance(prompt, list):
            pc = apply_llava_chat_template(self.tokenizer, prompt[0])
            pr = apply_llava_chat_template(self.tokenizer, prompt[1])
        else:
            pc = pr = apply_llava_chat_template(self.tokenizer, prompt)
        chosen_s = self.processor(pc, [self._open(chosen)])
        reject_s = self.processor(pr, [self._open(reject)])
        return chosen_s, reject_s, float(c_rate), float(r_rate)


def _qwen_budgets(processor, patch_budget, unit_budget):
    """Static patch/unit budgets from the processor's pixel limits: windows
    are 64 patches; ragged edges can pad up to ~2x at extreme aspect ratios,
    so give headroom (callers with odd data can pass explicit budgets)."""
    if patch_budget is None:
        max_patches = processor.max_pixels // (processor.patch_size ** 2)
        patch_budget = 2 * ((max_patches + 63) // 64) * 64
    if unit_budget is None:
        max_patches = processor.max_pixels // (processor.patch_size ** 2)
        unit_budget = max_patches // (processor.merge_size ** 2)
    return patch_budget, unit_budget


class QwenPairwiseRewardDataset(PairwiseRewardDataset):
    """Qwen2.5-VL pairwise dataset: prompt construction matches the
    reference's qwen dataset (reward_dataset.py:404-430) via
    apply_qwen_chat_template; collate pads the windowed patch arrays."""

    def __init__(self, rows, processor, tokenizer, image_root=None,
                 patch_budget: Optional[int] = None,
                 unit_budget: Optional[int] = None):
        super().__init__(rows, processor, tokenizer, image_root)
        self.patch_budget, self.unit_budget = _qwen_budgets(
            processor, patch_budget, unit_budget
        )

    def _template(self, prompt: str) -> str:
        from ..preprocess.qwen_vision import apply_qwen_chat_template

        return apply_qwen_chat_template(self.tokenizer, prompt)

    def __getitem__(self, idx: int):
        prompt, chosen, reject, c_rate, r_rate = parse_pairwise_row(self.rows[idx])
        if isinstance(prompt, list):
            pc, pr = self._template(prompt[0]), self._template(prompt[1])
        else:
            pc = pr = self._template(prompt)
        chosen_s = self.processor(pc, [self._open(chosen)])
        reject_s = self.processor(pr, [self._open(reject)])
        return chosen_s, reject_s, float(c_rate), float(r_rate)

    def collate(self, items, seq_len: int, pad_token_id: int):
        from ..preprocess.collate import collate_qwen_samples

        chosen = collate_qwen_samples(
            [i[0] for i in items], seq_len, pad_token_id,
            self.patch_budget, self.unit_budget,
        )
        rejected = collate_qwen_samples(
            [i[1] for i in items], seq_len, pad_token_id,
            self.patch_budget, self.unit_budget,
        )
        c_rate = np.asarray([i[2] for i in items], np.float32)
        r_rate = np.asarray([i[3] for i in items], np.float32)
        return chosen, rejected, c_rate, r_rate


class QwenPointwiseRewardDataset(PointwiseRewardDataset):
    def __init__(self, rows, processor, tokenizer, image_root=None,
                 patch_budget: Optional[int] = None,
                 unit_budget: Optional[int] = None):
        super().__init__(rows, processor, tokenizer, image_root)
        self.patch_budget, self.unit_budget = _qwen_budgets(
            processor, patch_budget, unit_budget
        )

    def __getitem__(self, idx: int):
        from PIL import Image, ImageFile

        from ..preprocess.qwen_vision import apply_qwen_chat_template

        ImageFile.LOAD_TRUNCATED_IMAGES = True
        prompt, path, label = parse_pointwise_row(self.rows[idx])
        text = apply_qwen_chat_template(self.tokenizer, prompt)
        if self.image_root:
            path = os.path.join(self.image_root, path)
        sample = self.processor(text, [Image.open(path).convert("RGB")])
        return sample, int(label)

    def collate(self, items, seq_len: int, pad_token_id: int):
        from ..preprocess.collate import collate_qwen_samples

        batch = collate_qwen_samples(
            [i[0] for i in items], seq_len, pad_token_id,
            self.patch_budget, self.unit_budget,
        )
        labels = np.asarray([i[1] for i in items], np.float32)
        return batch, labels


def rewrite_paths(json_path: str, old_base: str, new_base: str, out_path: str) -> int:
    """Data-prep tool: rebase chosen_path/reject_path/path prefixes
    (data/re_path.py:5-21)."""
    rows = load_json_dataset(json_path)
    n = 0
    for row in rows:
        for key in ("chosen_path", "reject_path", "path"):
            if key in row and isinstance(row[key], str) and row[key].startswith(old_base):
                row[key] = new_base + row[key][len(old_base):]
                n += 1
    with open(out_path, "w") as f:
        json.dump(rows, f, indent=2)
    return n
