"""zkput — load a fixture JSON file into a ZooKeeper tree.

The write-side (registrar-equivalent) companion tool: the reference's
records are written into ZK by the separate `registrar` service; this tool
lets operators and tests populate a store the same way.

Usage: zkput [-z host:port] fixture.json
  fixture.json maps znode paths to record objects:
    {"/com/foo/web": {"type": "host", "host": {"address": "10.0.0.1"}}}
"""
# The counterpart of bin/zkput, run as ``python -m binder_torch.cli.zkput``:
# the same options, output and exit codes (the docstring is its usage).
import asyncio
import json
import sys

from binder_torch.store.zk_client import ZKClient


async def run(host, port, fixture):
    client = ZKClient(address=host, port=port, session_timeout_ms=10000)
    client.start()
    for _ in range(100):
        if client.is_connected():
            break
        await asyncio.sleep(0.1)
    else:
        print("zkput: cannot connect", file=sys.stderr)
        return 1
    with open(fixture) as f:
        tree = json.load(f)
    for path, obj in tree.items():
        await client.mkdirp(path, json.dumps(obj).encode())
        print(f"put {path}")
    client.close()
    return 0


def main():
    args = sys.argv[1:]
    host, port = "127.0.0.1", 2181
    if args and args[0] == "-z":
        hp = args[1]
        host, _, p = hp.partition(":")
        port = int(p or 2181)
        args = args[2:]
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    return asyncio.run(run(host, port, args[0]))


if __name__ == "__main__":
    sys.exit(main())
