"""Built-in web UI (counterpart of ``avede_tpu/web``)."""
