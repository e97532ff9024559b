"""Framework-free point-cloud, result-file and host NMS helpers."""
