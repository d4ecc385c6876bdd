"""The yardstick's arithmetic: published peaks and the operations and bytes
of the kernels whose roofline share a metric reads."""
