"""Logits-processor constants (mic_tpu/generate/processors.py).

Forced tokens and min-length EOS blocking act on candidates in
generate/search.py; this module keeps the search's mask constant, which is
finite so that masked scores stay ordered and a NEG_INF sum never turns
into NaN.
"""

NEG_INF = -1e7
