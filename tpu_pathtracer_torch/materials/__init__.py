"""BSDF samplers and Fresnel terms."""
