"""The traffic generators, one module each, named by a mix's ``generator``;
the mixes themselves are data, `traffic/mixes/<mix>.json`."""
