"""Geolocation evaluation (reference: ``utils.py :: geo_eval``).

Load-bearing semantics (SURVEY.md §3.3): predicted coordinate for a user is
the *median* (lat, lon) of their argmax class; error is the haversine
distance to the true coordinate; reported metrics are Acc@161 (fraction
within 161 km ≈ 100 miles), mean error km, median error km. Pure numpy on
host — no device involvement, exactly like the reference.
"""

from __future__ import annotations

import numpy as np

EARTH_RADIUS_KM = 6371.0
ACC_THRESHOLD_KM = 161.0


def haversine_km(lat1, lon1, lat2, lon2) -> np.ndarray:
    """Great-circle distance in km (vectorized)."""
    lat1, lon1, lat2, lon2 = (np.radians(np.asarray(x, np.float64)) for x in (lat1, lon1, lat2, lon2))
    dlat = lat2 - lat1
    dlon = lon2 - lon1
    a = np.sin(dlat / 2.0) ** 2 + np.cos(lat1) * np.cos(lat2) * np.sin(dlon / 2.0) ** 2
    return 2.0 * EARTH_RADIUS_KM * np.arcsin(np.minimum(np.sqrt(a), 1.0))


def geo_eval(
    pred_classes: np.ndarray,
    true_lat: np.ndarray,
    true_lon: np.ndarray,
    class_lat_median: np.ndarray,
    class_lon_median: np.ndarray,
) -> dict:
    """Returns {"acc_at_161", "mean_km", "median_km", "distances"}."""
    pred_classes = np.asarray(pred_classes)
    pred_lat = np.asarray(class_lat_median)[pred_classes]
    pred_lon = np.asarray(class_lon_median)[pred_classes]
    d = haversine_km(pred_lat, pred_lon, true_lat, true_lon)
    return {
        "acc_at_161": float(np.mean(d <= ACC_THRESHOLD_KM)),
        "mean_km": float(np.mean(d)),
        "median_km": float(np.median(d)),
        "distances": d,
    }
