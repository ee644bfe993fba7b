"""Model zoo of the port: the dense GQA transformer family."""
