"""Request templates, one file each, named in a traffic mix's ``block``."""
