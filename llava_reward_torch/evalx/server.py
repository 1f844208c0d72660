"""Reward-scoring HTTP server (``llava_reward_tpu/evalx/server.py``).

POST /score        {"caption": str, "images": [path|base64, ...]}
                   -> {"rewards": [[...], ...], "prob_first_over_second": p?}
POST /score_pair   {"prompt": str, "chosen": path|b64, "rejected": path|b64}
                   -> {"prob": float, "chosen_reward": [...], ...}
GET  /healthz

Each device call is shaped to the rows it carries: exactly its rows, the
tokens left-padded to the longest row rounded up to 128 (``seq_len`` caps a
row, cut from the right), and for Qwen2.5-VL the windowed patches
right-padded to the longest row's, rounded up to 128, and the merged units
to the longest row's. Padding adds nothing to a row's reward. Host
preprocessing runs on the request threads; a batcher thread coalesces the
samples of every request that arrives within ``batch_window_ms`` into one
device call; the card's work is serialised by a lock. Grad mode is
thread-local in PyTorch, so the batcher and the request threads each enter
``torch.inference_mode()``; scoring runs on the adaptor's device, never on
a thread's current device.

Under a running ``torch.profiler`` the service records its spans and
counters (``utils/profiling``): ``serve.prep`` on the request threads;
``serve.queue`` (a request's wait for its last device call), ``serve.wait``,
``serve.call`` with its ``serve.collate`` and ``serve.step``, and the
``serve.rows`` / ``serve.pad_rows`` / ``serve.calls`` counters on the batcher,
with the tokens and patches its calls carry and compute (``serve.tokens``,
``serve.tokens_padded``, ``serve.patches``, ``serve.patches_padded``).

    python -m llava_reward_torch.evalx.server \\
        --pretrain <hf_dir> --pm_path <artifact> --port 8399 [--device cuda]
"""

from __future__ import annotations

import argparse
import base64
import io
import itertools
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from ..ops.flash_attention import _round_up
from ..preprocess.collate import collate_samples, to_reward_batch
from ..reward.preference import preference_prob
from ..utils import profiling
from ..utils.profiling import span

_request_ids = itertools.count(1)
_call = threading.local()  # .requests: the request ids of the device call being made
# each axis of a device call rounds up to this: the decoder's rows are whole 128-row
# tiles of the int8 GEMM and whole blocks of the attention kernels, the Qwen2.5-VL
# tower's patches whole 64-patch windows
_TILE = 128


def _load_image(spec: str):
    from PIL import Image

    if spec.startswith("data:") or (len(spec) > 512 and "/" not in spec[:64]):
        blob = base64.b64decode(spec.split(",")[-1])
        return Image.open(io.BytesIO(blob)).convert("RGB")
    return Image.open(spec).convert("RGB")


class RewardService:
    def __init__(self, adaptor, tokenizer, processor, seq_len: int = 2944,
                 max_batch: int = 8, batch_window_ms: float = 10.0):
        self.adaptor = adaptor
        self.tokenizer = tokenizer
        self.processor = processor
        self.seq_len = seq_len
        self.max_batch = max_batch
        self._score = adaptor.make_score_fn(training=False)
        self._lock = threading.Lock()
        self.batch_window_ms = batch_window_ms
        if batch_window_ms > 0:
            self._start_batcher()

    def _template(self, caption: str) -> str:
        mt = self.adaptor.model_type
        if mt == "qwen":
            from ..preprocess.qwen_vision import apply_qwen_chat_template

            return apply_qwen_chat_template(self.tokenizer, caption)
        if mt == "llava":
            from ..preprocess.llava_processor import apply_llava_chat_template

            return apply_llava_chat_template(self.tokenizer, caption)
        from ..preprocess.phi3v_processor import apply_phi3v_chat_template

        return apply_phi3v_chat_template(self.tokenizer, caption)

    def _collate_family(self, samples):
        """The host batch of ``samples`` at the call's own shape: each axis
        padded to its longest row, rounded up to ``_TILE``."""
        cfg = self.adaptor.cfg
        pad_id = (cfg.decoder if hasattr(cfg, "decoder") else cfg.text).pad_token_id
        seq = min(self.seq_len, _round_up(max(len(s.input_ids) for s in samples), _TILE))
        if self.adaptor.model_type == "qwen":
            from ..preprocess.collate import collate_qwen_samples

            imgs = [s for s in samples if s.patches is not None]
            patches = _round_up(max((s.patches.shape[0] for s in imgs), default=0), _TILE)
            units = max((s.unit_gather.shape[0] for s in imgs), default=0)
            return collate_qwen_samples(samples, seq, pad_id, patches, units)
        # no crop buckets: every image at the crop budget
        return collate_samples(samples, seq, pad_id, crop_buckets=None)

    # ------------------------------------------------ cross-request batching
    #
    # ThreadingHTTPServer gives every request its own thread; requests
    # enqueue their processed samples and one batcher thread coalesces all
    # that arrive within ``batch_window_ms`` (up to max_batch requests) into
    # device calls of up to max_batch samples, so concurrent clients share a
    # forward.

    def _start_batcher(self):
        self._queue = queue.Queue()
        threading.Thread(target=self._batcher_loop, daemon=True,
                         name="RewardService-batcher").start()

    def _batcher_loop(self):
        with torch.inference_mode():
            while True:
                with span("serve.wait"):
                    first = self._queue.get()
                    items = [first]
                    deadline = time.monotonic() + self.batch_window_ms / 1000.0
                    while len(items) < self.max_batch:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        try:
                            items.append(self._queue.get(timeout=remaining))
                        except queue.Empty:
                            break
                samples = [s for it in items for s in it["samples"]]
                ids = [it["id"] for it in items for _ in it["samples"]]
                try:
                    # overflow beyond max_batch runs as follow-up batches
                    parts = []
                    for off in range(0, len(samples), self.max_batch):
                        end = min(off + self.max_batch, len(samples))
                        if profiling.recording():
                            _record_queue(items, off, end)
                        _call.requests = list(dict.fromkeys(ids[off:end]))
                        parts.append(self._score_samples(samples[off:end]))
                    rewards = np.concatenate(parts)
                    pos = 0
                    for it in items:
                        k = len(it["samples"])
                        it["result"] = rewards[pos: pos + k]
                        pos += k
                except Exception as e:  # reaches every waiting request
                    for it in items:
                        it["error"] = e
                for it in items:
                    it["event"].set()

    def _score_samples(self, samples) -> np.ndarray:
        n = len(samples)
        with span("serve.call", rows=n, requests=getattr(_call, "requests", None)):
            profiling.count("serve.calls")
            profiling.count("serve.rows", n)
            profiling.count("serve.pad_rows", 0)
            with span("serve.collate"):
                host = self._collate_family(samples)
                if profiling.recording():
                    _count_fill(host)
                batch = to_reward_batch(host, self.adaptor.device)
            with self._lock, torch.inference_mode(), span("serve.step"):
                r = self._score(self.adaptor.params, batch).float().cpu().numpy()
        return r

    def score(self, caption: str, images) -> np.ndarray:
        rid = next(_request_ids)
        with span("serve.prep", request=rid, images=len(images)):
            text = self._template(caption)
            samples = [self.processor(text, [_load_image(im)]) for im in images]
        if self.batch_window_ms <= 0:
            _call.requests = [rid]
            return self._score_samples(samples)
        item = {"samples": samples, "event": threading.Event(), "result": None, "error": None,
                "id": rid, "queued_ns": profiling.now()}
        self._queue.put(item)
        item["event"].wait()
        if item["error"] is not None:
            raise item["error"]
        return item["result"]

    def preference(self, chosen_rewards, reject_rewards) -> float:
        rcfg = self.adaptor.rcfg
        with torch.inference_mode():
            p = preference_prob(
                torch.as_tensor(chosen_rewards), torch.as_tensor(reject_rewards),
                is_general_preference=rcfg.is_general_preference,
                value_head_dim=rcfg.value_head_dim, tau=rcfg.general_preference_tau)
        return float(p[0])


def _count_fill(host) -> None:
    """The valid tokens and patches of a host batch against those its call
    computes (on the host arrays: no device sync)."""
    mask = host["attention_mask"]
    profiling.count("serve.tokens", int(np.count_nonzero(mask)))
    profiling.count("serve.tokens_padded", mask.size)
    segments = host.get("patch_valid")
    if segments is not None:
        profiling.count("serve.patches", int(np.count_nonzero(segments)))
        profiling.count("serve.patches_padded", segments.size)


def _record_queue(items, off: int, end: int) -> None:
    """``serve.queue`` for each request whose last row is in rows
    ``[off, end)`` of the coalesced batch: its wait up to this call."""
    t, last = profiling.now(), 0
    for it in items:
        last += len(it["samples"])
        if off < last <= end:
            profiling.record("serve.queue", it["queued_ns"], t, request=it["id"])


def make_handler(service: RewardService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # quiet
            pass

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"ok": True})
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                if self.path == "/score":
                    r = service.score(req["caption"], req["images"])
                    out = {"rewards": r.tolist()}
                    if len(req["images"]) == 2:
                        out["prob_first_over_second"] = service.preference(r[:1], r[1:2])
                    self._reply(200, out)
                elif self.path == "/score_pair":
                    r = service.score(req["prompt"], [req["chosen"], req["rejected"]])
                    self._reply(200, {"prob": service.preference(r[:1], r[1:2]),
                                      "chosen_reward": r[0].tolist(),
                                      "rejected_reward": r[1].tolist()})
                else:
                    self._reply(404, {"error": "not found"})
            except Exception as e:
                self._reply(500, {"error": str(e)})

    return Handler


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--pretrain", required=True)
    p.add_argument("--pm_path", required=True)
    p.add_argument("--model_type", default="phi3v", choices=["phi3v", "qwen", "llava"])
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8399)
    p.add_argument("--seq_len", type=int, default=2944)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from transformers import AutoTokenizer

    from ..core.registry import get_family
    from .adaptor import load_reward_adaptor

    family = get_family(args.model_type)
    adaptor = load_reward_adaptor(args.pretrain, args.pm_path, model_type=args.model_type,
                                  compute_dtype=torch.bfloat16, device=args.device)
    tokenizer = AutoTokenizer.from_pretrained(args.pretrain, trust_remote_code=True)
    family.tokenizer_setup(tokenizer)
    processor = family.make_processor(tokenizer, adaptor.cfg)

    service = RewardService(adaptor, tokenizer, processor, seq_len=args.seq_len)
    server = ThreadingHTTPServer((args.host, args.port), make_handler(service))
    print(f"reward server on {args.host}:{server.server_port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
