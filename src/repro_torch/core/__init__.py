"""EEI core of the port: minors, the log-space identity and sign recovery."""
