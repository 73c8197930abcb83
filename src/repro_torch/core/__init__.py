"""The paper's numerical core, ported to PyTorch (see ``repro_torch``)."""
