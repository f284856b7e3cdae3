"""Traffic clients for driving a port server the way the internet does.

Each module is the counterpart of one of ``tools/``'s clients, with the
same names, options and report keys, built on ``binder_torch.dns.wire``
and the standard library only:

- ``hostile`` (``tools/hostile.py``): the adversarial multi-flow
  harness (malformed, EDNS-edge, oversized and random-name frames, a
  spoofed-prefix flood) and the paced legit probe; also the generator
  of ``tests/data/malformed_corpus.bin``.
  ``python -m binder_torch.loadgen.hostile --port P`` runs a flood.
- ``population`` (``tools/population.py``): Zipf-distributed client
  identities behind NAT'd resolver farms, direct clients, a spoofed
  overlay, and TCP retries on slip or timeout: the traffic RRL v2's
  allowlist and adaptive buckets are judged by.

Unlike the ``tools/`` clients, a source address the host refuses to
bind raises :class:`SourceBindError` instead of falling back to
127.0.0.1: a flood that silently collapsed onto one address would
measure a different thing.
"""


class SourceBindError(OSError):
    """The host refused to bind a client socket to its source address."""


def bind_source(sock, src_ip: str) -> None:
    """Bind ``sock`` to ``src_ip`` on an ephemeral port, or raise
    :class:`SourceBindError` naming the address."""
    try:
        sock.bind((src_ip, 0))
    except OSError as e:
        sock.close()
        raise SourceBindError(e.errno,
                              f"cannot bind source {src_ip}: "
                              f"{e.strerror}") from e
