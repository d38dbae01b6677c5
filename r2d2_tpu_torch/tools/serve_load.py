"""One load-generating client process of a policy server: N lanes of a
``RemoteBatchedPolicy`` over TCP, acting on random frames for a fixed
time, each tick one pipelined exchange of N requests.

    python -m r2d2_tpu_torch.tools.serve_load --port 5999 --lanes 8 \\
        --seconds 5 --frame 84 [--start-at UNIX_TIME]

``--start-at``: connect, then wait until that wall-clock time before the
first request, so several processes started together load the server in
one window whatever their start-up took. Prints one JSON line: lanes,
exchanges, requests, the window's seconds, requests/s, and the exchange
latency's p50/p99 in ms (one exchange is the round trip of the tick's N
requests, what an actor waits). The client
holds no model and hides every CUDA device, so several such processes
load a server from the host's cores without one GIL between them
(``chip_smoke.py`` phase 9 runs them against ``cli.serve``).
"""

import argparse
import json
import os
import sys
import time


def main(argv=None) -> dict:
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    import numpy as np

    from r2d2_tpu_torch.serve.client import RemoteBatchedPolicy
    from r2d2_tpu_torch.serve.transport import SocketChannel

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--lanes", type=int, default=1)
    p.add_argument("--client-base", type=int, default=0,
                   help="the first lane's client id")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--frame", type=int, default=84,
                   help="frame height and width")
    p.add_argument("--action-dim", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--start-at", type=float, default=0.0,
                   help="wall-clock time of the first request (0 = now)")
    args = p.parse_args(argv)

    rng = np.random.default_rng(args.seed)
    n = args.lanes
    policy = RemoteBatchedPolicy(
        SocketChannel(args.host, args.port, connect_retries=10,
                      eager_connect=True),
        args.action_dim, [0.0] * n, list(range(args.seed, args.seed + n)),
        client_base=args.client_base)
    frames = rng.integers(0, 255, (16, n, args.frame, args.frame), np.uint8)
    time.sleep(max(0.0, args.start_at - time.time()))
    for i in range(n):
        policy.observe_reset_lane(i, frames[0, i])
    policy.act()                              # first contact, not timed
    latencies = []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds:
        policy.observe(frames[len(latencies) % 16], np.zeros(n, np.int64))
        t = time.perf_counter()
        policy.act()
        latencies.append(time.perf_counter() - t)
    seconds = time.perf_counter() - t0
    policy.close()
    ms = np.asarray(latencies) * 1e3
    out = {"lanes": n, "exchanges": len(latencies),
           "requests": len(latencies) * n, "seconds": seconds,
           "requests_per_s": len(latencies) * n / seconds,
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "timeouts": policy.timeouts}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
