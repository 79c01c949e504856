"""The port's own count of the bytes its index-batching representation
keeps (``IndexDataset.nbytes_index()``: the resident series and the start
array), in GiB."""


def read(rec):
    return rec.resident_bytes / 2 ** 30 if rec.resident_bytes else None
