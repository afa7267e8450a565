"""Data: the HDF5 subset of cooler files (hdf5.py), .mcool reading and
writing, preprocessing, cached patch modules, reassembly (port of
hicdiff_tpu/data)."""
