"""The plain reference: exact neighbours and distances in plain PyTorch,
and the judge that decides ``correct``.  Imports nothing of the program."""
