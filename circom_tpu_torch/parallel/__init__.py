"""Several devices and several processes: the batch split over a mesh."""
