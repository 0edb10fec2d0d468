"""Plain float32 references, one module per model family (the
configuration file's ``family``): ``weight_spec(conf)``, the layout and
initialisation of the weights the benchmark makes, and ``loss(tree,
batch, conf, mm)``, the training loss as plain PyTorch computes it, layer
by layer under checkpoints so that it fits beside nothing else.  They
import nothing of the program."""
