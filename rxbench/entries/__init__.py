"""Entries: how a configuration's receiver is built and driven, one module
a configuration names under ``entry``.

Each module defines ``Entry(config, device, ingest)`` with
``dispatch_samples`` (input samples a dispatch), ``blocks_per_dispatch``,
``host_input(chunk)`` (the host buffer the window hands over),
``run(buffers, clock)`` (drives the receiver over the buffers, calling
``clock.called()`` as each dispatch starts and ``clock.done()`` once its
frames are on the host), ``rows()`` (the reported frames as columns) and
``reset()`` (a fresh receiver state, the same device tables).
"""
