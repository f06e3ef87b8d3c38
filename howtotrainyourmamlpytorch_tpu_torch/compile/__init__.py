"""The prewarm of the planned program families (``compile/aot.py``)."""
