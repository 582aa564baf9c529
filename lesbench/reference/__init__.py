"""The benchmark's plain reference: a frozen copy of the LES step in
plain PyTorch and NumPy (``les``) and the comparison that decides
``correct`` (``check``)."""
