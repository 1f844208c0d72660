"""A configuration's family hooks: ``benchmark/families/<family>.py``, found by
the configuration file's ``family`` (its chat template, its rows' shapes and
work, its weights' layout, the port's config for it, its plain reference)."""

from __future__ import annotations

import importlib


def load(name: str):
    return importlib.import_module(f"benchmark.families.{name}")


def of(cfg: dict):
    return load(cfg["family"])


def row_shape(cfg: dict, tok, text: str, width: int, height: int) -> tuple:
    """(valid tokens, image tokens, grid): crops (hc, wc) for phi3v, patches
    (gh, gw) for qwen."""
    return of(cfg).row_shape(cfg, tok, text, width, height)


def row_work(cfg: dict, shape: tuple, slots: int, w8a8: bool):
    return of(cfg).row_work(cfg, shape, slots, w8a8)


def ref_reward(cfg: dict, weights: dict, tok, text: str, png: bytes, slots: int, device,
               w8a8: bool):
    return of(cfg).ref_reward(cfg, weights, tok, text, png, slots, device, w8a8)
