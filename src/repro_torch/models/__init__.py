"""Model families of the port (the DLRM MLP tower so far)."""
