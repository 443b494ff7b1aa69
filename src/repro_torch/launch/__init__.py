"""Entry points of the port: the LM trainer ``python -m
repro_torch.launch.train`` and the train steps it runs (``steps``)."""
