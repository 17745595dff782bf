"""python_table_share.opt: the Huffman tables the window's calls built in
Python (``device_encode.python_table_builds``) over all they built (with
``device_encode.native_table_builds``), percent; 0 where the native
builder made every table.  Reads nothing where neither counter moved (a
program without them)."""

NATIVE = "device_encode.native_table_builds"
PYTHON = "device_encode.python_table_builds"


def read(run):
    c = run.window.counters
    native, python = c.get(NATIVE, 0), c.get(PYTHON, 0)
    if native + python <= 0:
        return None
    return 100.0 * python / (native + python)
