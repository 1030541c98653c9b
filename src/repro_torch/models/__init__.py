"""Model families of the port: the DLRM MLP tower and the dense decoder
(``common``, ``attention``, ``ffn``, ``transformer``)."""
