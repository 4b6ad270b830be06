#!/usr/bin/env python3
"""Time node registration through a running server: ``--nodes`` mock
nodes in 4 datacenters, registered one by one with ``Server.node_register``
(each a raft apply that commits the node axis of the state store's planes),
and print the seconds they took as one JSON line.

    python3 nomad_tpu_torch/tools/register_time.py [--nodes 10000]
        [--device cpu] [--tree DIR]

The server wants the card unless ``--device cpu`` is given; registration
is host work, and the card is only where the server would keep its planes.
``--tree DIR`` times another checkout's package (for example one unpacked
with ``git archive`` under ``build/``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, default=10_000)
    ap.add_argument("--device", default=None)
    ap.add_argument("--tree", type=Path, default=ROOT)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.core.server import Server

    nodes = []
    for i in range(args.nodes):
        node = mock.node()
        node.datacenter = f"dc{i % 4 + 1}"
        nodes.append(node)
    server = Server({"seed": 42, "heartbeat_ttl": 86400.0}, device=args.device)
    server.start(num_workers=0, wait_for_leader=5.0)
    try:
        t0 = time.perf_counter()
        for node in nodes:
            server.node_register(node)
        seconds = time.perf_counter() - t0
    finally:
        server.stop()
    print(json.dumps({"nodes": args.nodes, "register_s": seconds, "device": str(server.device),
                      "tree": str(args.tree.resolve())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
