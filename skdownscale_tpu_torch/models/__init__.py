"""Estimators and their batched (cells, time) implementations; MBCn
(``mbc.py``) has its own grid runner, ``mbcn_grid``."""
