"""Host-side media: the file reader and writer, and the annotation overlay
(counterpart of ``truely_tpu/media``, with ``rawavi`` in place of the
native libav decoder and x264 writer)."""
