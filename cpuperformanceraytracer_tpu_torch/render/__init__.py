"""Frame step (kernel A -> kernel B) and the OfflineRenderer."""
