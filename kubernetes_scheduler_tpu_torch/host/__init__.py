"""The host layer of the port (counterpart of kubernetes_scheduler_tpu/host/)."""
