"""Command-line tools of the port: the decoder CLI `juicer`."""
