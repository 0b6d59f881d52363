"""Named test inputs, generated from fixed seeds (utils/corpus.py), in the
sizes of the documents the reference codec was tested on."""
from deflate_compression_tpu.utils import corpus

TEXT_57K = corpus.text(57_000, seed=1)      # a film script's size
TEXT_20K = corpus.text(20_502, seed=2)      # RFC 1950's size
TEXT_37K = corpus.text(36_944, seed=3)      # RFC 1951's size
PIXELS = corpus.pixels(3 * 256 * 256, seed=4)
