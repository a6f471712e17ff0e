"""Host-side media: the file reader and writer, and the annotation overlay
(counterpart of ``truely_tpu/media``): the native libav decoder and x264
writer and the frame helpers (``csrc/*.cpp``, built at first use by
``host_build``), ``rawavi`` for uncompressed I420 AVI, and cv2."""
