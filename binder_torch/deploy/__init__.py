"""The port's systemd install: ``systemd/`` holds the units (the
reference's ``deploy/systemd/`` with ``ExecStart`` lines that run the
port), ``README.md`` the install sketch, and ``systemctl_shim`` a
``systemctl`` stand-in that runs those units where no systemd is
booted (a test double for the smoke and the tests)."""
