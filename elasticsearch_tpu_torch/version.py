"""Version constants.

Counterpart of ``elasticsearch_tpu/version.py``: one place for the engine
version (the ``GET /`` response's ``version.number``) and the format
versions of the segment layout.
"""

__version__ = "0.1.0"

# Index format version written into segment metadata; bumped on
# incompatible changes to the on-disk segment layout.
INDEX_FORMAT_VERSION = 1

# Lucene-equivalent: version of the block-packed posting layout.
POSTING_FORMAT_VERSION = 1
