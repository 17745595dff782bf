"""unspanned_ms.* (``unspanned_ms.decode``, ``.live``, ``.rstless``):
the decode calls' host-clock time outside every layer span of either
decode path, ms a frame.  The layer spans are the stream entry's
(``split``, ``for_stream``), the restart path's (``prepare``,
``dispatch``, ``readback``) and the speculative engine's (``spec_*``);
the nested ``upload`` spans and the outermost ``stream`` and ``batch``
spans are not subtracted.  So ``host_other_ms`` is ``split_ms`` +
``for_stream_ms`` + ``readback_ms`` + this, in a cell that reports
them.  Reads nothing where the program opens no host-read span
(``readback`` or ``spec_readback``): without one, the layer spans are
not all there to subtract."""

from perfbench import readers

LAYER_SPANS = (
    "device_decode.split", "device_decode.for_stream",
    "device_decode.prepare", "device_decode.dispatch",
    "device_decode.readback",
    "device_decode.spec_parse", "device_decode.spec_prepare",
    "device_decode.spec_dispatch", "device_decode.spec_dense",
    "device_decode.spec_readback",
)
READS = ("device_decode.readback", "device_decode.spec_readback")


def read(run):
    if not any(run.window.spans.get(n, (0, 0.0))[0] for n in READS):
        return None
    return readers.host_other_ms_per_frame(run, *LAYER_SPANS)
