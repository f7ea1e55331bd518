"""Megabytes (10^6 B) of host bool mask packed and unpacked per drive: the
change of the program's ``PACK.mask_bytes_packed`` plus
``PACK.mask_bytes_unpacked`` over each drive's top-level spans (one
object x server byte per cell: each full pass over the scheme's host mask
adds its n_objects x n_servers bytes), the mean over the window's
drives."""
from bench import spans


def read(run):
    return spans.count(run, "mask_bytes_packed", "mask_bytes_unpacked", scale=1e-6)
