"""Model modules of the port: backbone, MVFex refiners, 3D lifter."""
