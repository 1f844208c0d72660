"""The serving cells' load: closed-loop HTTP clients in a process of their own
(so that their JSON and base64 work takes no time from the server's
threads), each sending ``/score_pair`` and waiting for the reply before its
next request.

    python3 -m benchmark.harness.clients --seed N --traffic '<traffic JSON>' 

makes the requests from the seed (``inputs.balanced_requests``: client c
sends requests c, c + clients, ...), prints ``ready``, reads
``go <port> <seconds>`` from standard input, sends for that many seconds,
waits for every request it sent, and prints one JSON line: each request's
index, client, start and end (seconds from go), HTTP status and rewards.
It imports no torch and nothing of the port.
"""

from __future__ import annotations

import argparse
import base64
import http.client
import json
import sys
import threading
import time

from . import inputs


def requests_for(seed: int, traffic: dict):
    sizes = traffic["image_sizes"]
    pool = inputs.image_pool(sizes, traffic["images_per_size"])
    reqs = inputs.balanced_requests(seed, len(sizes), traffic["images_per_size"],
                                    traffic["request_blocks"], *traffic["prompt_words"])
    return pool, reqs


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--traffic", required=True)
    args = p.parse_args(argv)
    traffic = json.loads(args.traffic)
    pool, reqs = requests_for(args.seed, traffic)
    b64 = ["data:image/png;base64," + base64.b64encode(
        inputs.png_bytes(inputs.pixels(args.seed, im))).decode() for im in pool]
    print("ready", flush=True)
    go = sys.stdin.readline().split()
    port, seconds = int(go[1]), float(go[2])
    n_clients = traffic["clients"]
    results = []
    lock = threading.Lock()
    t_go = time.perf_counter()
    t_end = t_go + seconds

    def client(c: int):
        mine = list(range(c, len(reqs), n_clients))
        k = 0
        while time.perf_counter() < t_end:
            i = mine[k % len(mine)]
            k += 1
            a, b, prompt = reqs[i]
            body = json.dumps({"prompt": prompt, "chosen": b64[a], "rejected": b64[b]})
            t0 = time.perf_counter()
            rec = {"i": i, "c": c, "t0": t0 - t_go}
            try:
                conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
                conn.request("POST", "/score_pair", body=body,
                             headers={"Content-Type": "application/json"})
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
                rec["status"] = resp.status
                if resp.status == 200:
                    out = json.loads(data)
                    rec["chosen"], rec["rejected"] = out["chosen_reward"], out["rejected_reward"]
            except (OSError, http.client.HTTPException, ValueError) as e:
                rec["status"], rec["error"] = 0, repr(e)
            rec["t1"] = time.perf_counter() - t_go
            with lock:
                results.append(rec)

    threads = [threading.Thread(target=client, args=(c,)) for c in range(n_clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print(json.dumps({"window_s": time.perf_counter() - t_go, "requests": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
