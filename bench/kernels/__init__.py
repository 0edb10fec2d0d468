"""Bytes and operations of the port's hand-written kernels, one module per
kernel: ``OP`` names the autograd function whose forward launches it (its
profiler range carries the launch's input shapes), ``FRAGMENTS`` the
fragments of its device kernels' names, and ``work(shapes, conf)`` the
bytes moved and operations done by one launch, with the peak that bounds
those operations.  The arithmetic is that of ``chip_smoke.py``'s phase 5."""
