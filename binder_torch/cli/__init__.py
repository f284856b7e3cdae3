"""The operator tools of ``bin/`` on the port.

Each module is the counterpart of one script there, with the same
options, output and exit codes, run as ``python -m binder_torch.cli.<name>``:

- ``bdig`` (``bin/bdig``): a dig-style query client;
- ``zkput`` (``bin/zkput``): loads a fixture into a ZooKeeper tree;
- ``config_render`` (``bin/binder-config-render``): renders
  ``etc/config.json`` from deployment metadata.

``bin/bstat`` and ``bin/balstat`` import no package (they read
``/status`` over HTTP and ``.balancer.stats`` over a socket) and serve
the port as they are.
"""
