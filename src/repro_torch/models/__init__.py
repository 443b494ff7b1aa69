"""Models of the port: the paper's §V MLP (``mlp_mnist``) and the dense
GQA decoders (``transformer``), behind ``registry.build_model``."""
