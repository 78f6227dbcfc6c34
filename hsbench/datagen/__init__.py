"""Data generators, one file each, named by a configuration's ``datagen``."""
