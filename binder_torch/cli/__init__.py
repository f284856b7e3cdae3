"""The operator tools of ``bin/`` on the port, and glibc's resolver as a
conformance client.

Each module is the counterpart of one script, with the same options,
output and exit codes, run as ``python -m binder_torch.cli.<name>``:

- ``bdig`` (``bin/bdig``): a dig-style query client;
- ``zkput`` (``bin/zkput``): loads a fixture into a ZooKeeper tree;
- ``config_render`` (``bin/binder-config-render``): renders
  ``etc/config.json`` from deployment metadata;
- ``libresolv_probe`` (``tools/libresolv_probe.py``): asks through
  glibc's resolver and prints what ``ns_parserr`` read, with one added
  option, ``--server HOST:PORT``;
- ``conformance_tiers`` (``tools/conformance_tiers.py``): which of the
  port's independent-conformance tiers ran, from a junit report.

``resolv_ns`` has no counterpart there: it runs a command in a private
network and mount namespace whose resolv.conf names 127.0.0.1:53, so
that glibc's stub resolver (``getent``) reaches a server there without
a change to the host.

``bin/bstat`` and ``bin/balstat`` import no package (they read
``/status`` over HTTP and ``.balancer.stats`` over a socket) and serve
the port as they are.
"""
