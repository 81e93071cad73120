"""Data-parallel training of the torch port (``parallel/ddp.py``)."""
