"""Host code of the port (counterpart of the same-named package of ``rabbittclust_tpu``)."""
