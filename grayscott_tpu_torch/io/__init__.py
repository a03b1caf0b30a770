"""File I/O of the port: the HDF5 snapshot writer."""
