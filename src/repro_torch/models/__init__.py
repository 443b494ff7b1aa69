"""Models of the port: the paper's §V MLP (``mlp_mnist``)."""
