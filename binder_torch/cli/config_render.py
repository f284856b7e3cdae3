"""binder-config-render — render etc/config.json from deploy metadata.

The config-agent analog (reference renders etc/config.json from SAPI
metadata through sapi_manifests/binder/{manifest.json,template}).

Usage:
    binder-config-render -m metadata.json [-M manifest] [-t template]
                         [-o output | -]

where ``binder-config-render`` is ``python -m
binder_torch.cli.config_render``, the counterpart of
``bin/binder-config-render`` with the same options, output and exit
codes.

With no -o, writes to the manifest's "path"; "-o -" prints to stdout.
The rendered output must be valid JSON; rendering fails before anything
is written so a bad template never replaces a good config.
"""
import argparse
import json
import os
import subprocess
import sys

from binder_torch.config.render import render

#: ``deploy/config`` beside the package, as ``bin/`` finds it
DEPLOY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "deploy", "config")


def main():
    ap = argparse.ArgumentParser(prog="binder-config-render")
    ap.add_argument("-m", "--metadata", required=True,
                    help="JSON file of deployment metadata")
    ap.add_argument("-M", "--manifest",
                    default=os.path.join(DEPLOY, "manifest.json"))
    ap.add_argument("-t", "--template", default=None)
    ap.add_argument("-o", "--output", default=None,
                    help="output path; '-' for stdout")
    ap.add_argument("-c", "--on-change", default=None, metavar="CMD",
                    help="shell command run after the output file's "
                         "content actually changed (config-agent's "
                         "restart-consumers-on-change semantics); not "
                         "run when the rendered config is byte-identical")
    args = ap.parse_args()

    with open(args.metadata) as f:
        metadata = json.load(f)
    with open(args.manifest) as f:
        manifest = json.load(f)
    tpath = args.template or os.path.join(
        os.path.dirname(args.manifest), "template")
    with open(tpath) as f:
        template = f.read()

    rendered = render(template, metadata)
    # never emit a config the server cannot parse
    try:
        json.loads(rendered)
    except ValueError as e:
        print(f"binder-config-render: rendered output is not valid "
              f"JSON: {e}", file=sys.stderr)
        sys.exit(1)

    dest = args.output or manifest.get("path")
    if dest == "-":
        sys.stdout.write(rendered)
        return
    if not dest:
        print("binder-config-render: no output path (manifest has no "
              "'path' and -o not given)", file=sys.stderr)
        sys.exit(1)
    os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
    # change detection gates the on-change hook (and skips the rewrite):
    # an idempotent re-push of identical metadata must not restart every
    # consumer — config-agent only restarts on rendered-content change
    try:
        with open(dest) as f:
            unchanged = f.read() == rendered
    except OSError:
        unchanged = False
    if unchanged:
        print(f"binder-config-render: {dest} unchanged")
        return
    tmp = dest + ".tmp"
    with open(tmp, "w") as f:
        f.write(rendered)
    os.replace(tmp, dest)   # atomic: readers never see a half-written config
    print(f"binder-config-render: wrote {dest}")
    if args.on_change:
        rc = subprocess.run(args.on_change, shell=True).returncode
        if rc != 0:
            # the config IS updated; surface the consumer-restart
            # failure rather than masking it as success
            print(f"binder-config-render: on-change command failed "
                  f"(exit {rc}): {args.on_change}", file=sys.stderr)
            sys.exit(rc)


if __name__ == "__main__":
    main()
