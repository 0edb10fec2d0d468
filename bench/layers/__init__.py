"""Model FLOPs of one layer, one module per layer kind (the configuration
file's ``layer_kinds``): ``forward_flops(conf, batch, seq)``, the forward
FLOPs of one layer of that kind (see :mod:`bench.flops`)."""
