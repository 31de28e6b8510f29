"""Training: AdamW (``optimizer``), the microbatched, rematerialised
train step (``trainstep``), gradient compression (``compression``) and
timestamp-vector asynchronous data parallelism (``async_commit``)."""
