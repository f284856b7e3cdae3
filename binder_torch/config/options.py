"""Option handling: compiled defaults ← JSON config file ← CLI flags.

Port of the reference's three-layer merge (``main.js:34-38,51-108``) with
the same flags:

    -a <ms>    cache expiry (legacy, kept for flag compatibility)
    -b <path>  balancer UNIX socket path
    -s <n>     cache size (legacy)
    -p <port>  DNS listen port
    -f <file>  JSON config file (default ./etc/config.json)
    -v         increase verbosity (stackable, -vv -> trace)
    -h         usage

plus the shard-mode long options (docs/operations.md "Sharded
serving"):

    --shards <n|auto>   fork n serving workers behind one
                        SO_REUSEPORT port, supervised by this process
                        — the headline scale-out topology
                        (docs/operations.md).  ``auto`` sizes the
                        group to the machine (one worker per core).
                        (config key ``shards``; 0/absent = classic
                        single-process serving)
    --shard-worker <i>  INTERNAL: run as shard worker i, reading the
                        mutation log from the inherited
                        BINDER_SHARD_FD socketpair

The config file is the SAPI-rendered equivalent (reference
``sapi_manifests/binder/template``): ``dnsDomain``, ``datacenterName``,
optional ``recursion`` block, optional ``store`` block selecting the
coordination-store backend (``zookeeper`` with host/port, or ``fake`` with
an optional fixture file — the testing backend the reference lacks).
"""
from __future__ import annotations

import getopt
import json
import sys
from typing import Dict, List, Optional

DEFAULTS: Dict[str, object] = {
    "expiry": 60000,
    "size": 10000,
    "port": 53,
    "host": "0.0.0.0",
}

USAGE = ("usage: binder [-v] [-a cacheExpiry] [-s cacheSize] [-p port] "
         "[-b balancerSocket] [-f file] [--shards n|auto]")


class ConfigError(Exception):
    pass


def parse_options(argv: Optional[List[str]] = None) -> Dict[str, object]:
    argv = sys.argv[1:] if argv is None else argv
    try:
        optlist, _ = getopt.getopt(argv, "hva:b:s:p:f:",
                                   ["shards=", "shard-worker="])
    except getopt.GetoptError as e:
        raise ConfigError(f"{e}\n{USAGE}")

    cli: Dict[str, object] = {}
    verbosity = 0
    for flag, arg in optlist:
        if flag == "-a":
            cli["expiry"] = int(arg)
        elif flag == "-b":
            cli["balancerSocket"] = arg
        elif flag == "-f":
            cli["configFile"] = arg
        elif flag == "-p":
            cli["port"] = int(arg)
        elif flag == "-s":
            cli["size"] = int(arg)
        elif flag == "--shards":
            # "auto" = size the reuseport group to the machine; main.py
            # resolves it so the config-file form works identically
            cli["shards"] = arg if arg == "auto" else int(arg)
        elif flag == "--shard-worker":
            # internal: spawned by the shard supervisor, never by hand
            cli["shardWorker"] = int(arg)
        elif flag == "-v":
            verbosity += 1
        elif flag == "-h":
            raise ConfigError(USAGE)

    config_file = cli.get("configFile", "./etc/config.json")
    try:
        with open(config_file) as f:
            fopts = json.load(f)
    except (OSError, ValueError) as e:
        raise ConfigError(f"cannot load config {config_file}: {e}")

    options = dict(DEFAULTS)
    options.update(fopts)
    options.update(cli)
    if verbosity:
        options["logLevel"] = "debug" if verbosity == 1 else "trace"
    return options
