"""`python -m lpc_yolo_tpu_torch ...`: the `yolo` command line of the port (`cfg/__init__.py::entrypoint`)."""

from .cfg import entrypoint

if __name__ == "__main__":
    entrypoint()
