"""Meshes, materials, procedural stand-ins and the OBJ loader."""
