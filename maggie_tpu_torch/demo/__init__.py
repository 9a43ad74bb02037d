"""The matting demo on the port (port of ``demo/``): ``predict`` (the image
and video CLI), ``segmenters`` (where the guidance masks come from) and
``app`` (the model side and the HTTP server)."""
