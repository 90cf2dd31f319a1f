"""Prefill attention impl shared by every prefill consumer.

``PREFILL_ATTN_IMPL`` pins the kv tile width of the prefill attention core
at 16 (``attention_core`` impl ``"chunked:<kb>"``): with a pinned width a
fully masked tile is an exact no-op and a partly masked one reduces over the
same lanes whatever the padded length, so right-padding the key axis is
bit-transparent. On the card the flash kernel runs with this tile width;
on the CPU the plain pinned-tile chunked core does. The bucket ladder of
the JAX package's ``serve/bucketing.py`` comes with the paged engine.
"""
from __future__ import annotations

#: The prefill attention impl: online softmax with a PINNED 16-wide kv tile.
PREFILL_ATTN_IMPL = "chunked:16"
