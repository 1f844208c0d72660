"""A new configuration, traffic mix and per-layer metric (with a span and a
work counter of its own) are found by their names alone: files are added,
and BENCHMARK.json lists them; no file that was there changes. A family is
found by the configuration's ``family``."""

import hashlib
import json
import os

from helpers import last_json, make_root, run_cell, write_bench

from benchmark.harness import common


def _digests(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    before = _digests(root)
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "tiny_phi3v.json")) as f:
        cfg = json.load(f)
    cfg["text"]["num_hidden_layers"] = 3
    with open(os.path.join(b, "configs", "tiny_phi3v_deeper.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "tiny_eval.json")) as f:
        mix = json.load(f)
    mix.update(image_sizes=[[80, 80], [120, 60]], prompt_words=[4, 12])
    with open(os.path.join(b, "traffic", "tiny_eval_short.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(b, "metrics", "kernels_traced.eval.py"), "w") as f:
        f.write('def read(data):\n    return None if data is None else 1 + data["trace"]["kernels"]\n')
    # a metric with a span and a counter of its own
    with open(os.path.join(b, "metrics", "decoder_share.eval.py"), "w") as f:
        f.write('SPANS = {"bench.decoder": [("llava_reward_torch.models.phi3", "forward")]}\n\n'
                'def count(work):\n    return work.bound_s("attn.dec")\n\n'
                'def read(data):\n'
                '    return 100 * data["count"]["traced"] / data["count"]["window"]\n')
    with open(os.path.join(b, "limits", "tiny2.eval.json"), "w") as f:
        json.dump({"reward_gap": 0.05}, f)
    bench = common.load_benchmark(root)
    bench["configs"].append({"name": "tiny_phi3v_deeper", "source": "tiny", "reduced": [],
                             "file": "benchmark/configs/tiny_phi3v_deeper.json", "why": "t"})
    bench["workloads"].append({"name": "tiny2.eval", "config": "tiny_phi3v_deeper",
                               "traffic": "tiny_eval_short", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "kernels_traced.eval", "unit": "kernels",
                               "better": "lower", "source": "device_trace", "layer": "device",
                               "moves": "score_pairs_per_s", "workloads": ["tiny2.eval"]})
    bench["per_layer"].append({"name": "decoder_share.eval", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "model step",
                               "moves": "score_pairs_per_s", "workloads": ["tiny2.eval"]})
    for m in bench["end_to_end"]:
        if m["name"] == "score_pairs_per_s":
            m["workloads"].append("tiny2.eval")
    write_bench(root, bench)
    after = _digests(root)
    changed = [p for p in before if before[p] != after[p]]
    assert changed == ["BENCHMARK.json"]

    rc, out, err = run_cell(root, "tiny2.eval", trace=1)
    assert rc == 0, err[-3000:]
    line = last_json(out)
    assert line["metrics"]["kernels_traced.eval"]["value"] >= 1
    assert line["metrics"]["kernels_traced.eval"]["unit"] == "kernels"
    assert 0 < line["metrics"]["decoder_share.eval"]["value"] < 100
    rc, out, err = run_cell(root, "tiny2.eval", trace=0)
    assert rc == 0, err[-3000:]
    assert set(last_json(out)["metrics"]) == {"setup_s", "score_pairs_per_s", "peak_mem_gib"}


def test_each_configuration_names_a_family_file():
    from benchmark.harness import family

    for c in common.load_benchmark()["configs"]:
        with open(os.path.join(common.ROOT, c["file"])) as f:
            fam = family.of(json.load(f))
        for hook in ("render", "row_shape", "row_work", "weight_spec", "port_config",
                     "ref_reward", "DECODER"):
            assert hasattr(fam, hook), (c["name"], hook)
