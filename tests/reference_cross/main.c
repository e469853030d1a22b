/* Headless cross-validation harness around the ACTUAL reference renderer.
 *
 * Built by tests/test_reference_cross.py against the unmodified reference
 * sources (/root/reference/src/Terra.c etc.) and driven with a scene dumped
 * from the terra_tpu Python scene, so the JAX renderer's converged output
 * can be statistically compared with the true compiled C reference
 * (terra_render, Terra.c:512-635). RNG streams differ (the reference uses
 * libc rand(), Terra.c:115), so only converged-mean agreement is testable.
 *
 * Scene file format (text):
 *   cam_pos(3) cam_dir(3) cam_up(3) fov_deg
 *   n_objects
 *   per object: n_tris bsdf_type albedo(3) emissive(3) spec(3) intensity
 *               (bsdf_type 0 = diffuse, ignores spec/intensity;
 *                bsdf_type 1 = phong, TerraPresets.h TERRA_PHONG_*)
 *               then per tri: a(3) b(3) c(3) na(3) nb(3) nc(3)
 *
 * Output: one "r g b" line per pixel, row-major — the raw accumulation
 * plane divided by the sample count (framebuffer->results, Terra.h:183).
 */
#include <stdio.h>
#include <stdlib.h>

#include "Terra.h"
#include "TerraPresets.h"

static TerraFloat3 read_f3 ( FILE* f ) {
    float x, y, z;
    if ( fscanf ( f, "%f %f %f", &x, &y, &z ) != 3 ) {
        fprintf ( stderr, "scene parse error\n" );
        exit ( 2 );
    }
    return terra_f3_set ( x, y, z );
}

int main ( int argc, char** argv ) {
    if ( argc < 8 ) {
        fprintf ( stderr,
                  "usage: %s scene.txt out.txt W H SPP BOUNCES INTEGRATOR [SEED] [JITTER]\n",
                  argv[0] );
        return 2;
    }

    const char* scene_path = argv[1];
    const char* out_path = argv[2];
    int W = atoi ( argv[3] );
    int H = atoi ( argv[4] );
    int SPP = atoi ( argv[5] );
    int BOUNCES = atoi ( argv[6] );
    int INTEGRATOR = atoi ( argv[7] );
    unsigned SEED = argc > 8 ? ( unsigned ) atoi ( argv[8] ) : 1234u;
    float JITTER = argc > 9 ? ( float ) atof ( argv[9] ) : 0.5f;
    srand ( SEED );  /* seeds _randf(): the BSDF/NEE/roulette draws */

    FILE* f = fopen ( scene_path, "r" );
    if ( !f ) {
        perror ( "scene" );
        return 2;
    }

    TerraCamera cam;
    cam.position = read_f3 ( f );
    cam.direction = read_f3 ( f );
    cam.up = read_f3 ( f );
    if ( fscanf ( f, "%f", &cam.fov ) != 1 ) {
        return 2;
    }

    int n_objects = 0;
    if ( fscanf ( f, "%d", &n_objects ) != 1 ) {
        return 2;
    }

    HTerraScene scene = terra_scene_create();

    for ( int o = 0; o < n_objects; ++o ) {
        int ntris = 0, bsdf_type = 0;
        if ( fscanf ( f, "%d %d", &ntris, &bsdf_type ) != 2 ) {
            return 2;
        }
        TerraFloat3 albedo = read_f3 ( f );
        TerraFloat3 emissive = read_f3 ( f );
        TerraFloat3 spec = read_f3 ( f );
        float intensity = 0.f;
        if ( fscanf ( f, "%f", &intensity ) != 1 ) {
            return 2;
        }
        TerraObject* obj = terra_scene_add_object ( scene, ( size_t ) ntris );

        for ( int t = 0; t < ntris; ++t ) {
            obj->triangles[t].a = read_f3 ( f );
            obj->triangles[t].b = read_f3 ( f );
            obj->triangles[t].c = read_f3 ( f );
            obj->properties[t].normal_a = read_f3 ( f );
            obj->properties[t].normal_b = read_f3 ( f );
            obj->properties[t].normal_c = read_f3 ( f );
            obj->properties[t].texcoord_a = terra_f2_set ( 0.f, 0.f );
            obj->properties[t].texcoord_b = terra_f2_set ( 0.f, 0.f );
            obj->properties[t].texcoord_c = terra_f2_set ( 0.f, 0.f );
        }

        if ( bsdf_type == 1 ) {
            TerraFloat3 inten = terra_f3_set ( intensity, 0.f, 0.f );
            terra_bsdf_phong_init ( &obj->material.bsdf );
            terra_attribute_init_constant (
                &obj->material.attributes[TERRA_PHONG_ALBEDO], &albedo );
            terra_attribute_init_constant (
                &obj->material.attributes[TERRA_PHONG_SPECULAR_COLOR], &spec );
            terra_attribute_init_constant (
                &obj->material.attributes[TERRA_PHONG_SPECULAR_INTENSITY], &inten );
            terra_attribute_init_constant (
                &obj->material.attributes[TERRA_PHONG_SAMPLE_PICK], &inten );
            obj->material.attributes_count = TERRA_PHONG_END;
        } else {
            terra_bsdf_diffuse_init ( &obj->material.bsdf );
            terra_attribute_init_constant (
                &obj->material.attributes[TERRA_DIFFUSE_ALBEDO], &albedo );
            obj->material.attributes_count = TERRA_DIFFUSE_END;
        }
        terra_attribute_init_constant ( &obj->material.emissive, &emissive );
        obj->material.ior = 1.5f;
        obj->material.enable_bump_map_attr = false;
        obj->material.enable_normal_map_attr = false;
    }

    fclose ( f );

    TerraSceneOptions* opts = terra_scene_get_options ( scene );
    opts->accelerator = kTerraAcceleratorBVH;
    opts->sampling_method = kTerraSamplingMethodRandom;
    opts->integrator = ( TerraIntegrator ) INTEGRATOR;
    opts->bounces = ( size_t ) BOUNCES;
    opts->samples_per_pixel = ( size_t ) SPP;
    opts->subpixel_jitter = JITTER;
    opts->tonemapping_operator = kTerraTonemappingOperatorNone;
    opts->manual_exposure = 1.f;
    opts->gamma = 2.2f;
    TerraFloat3 env = terra_f3_set ( 0.f, 0.f, 0.f );
    terra_attribute_init_constant ( &opts->environment_map, &env );
    terra_scene_commit ( scene );

    TerraFramebuffer fb;
    if ( !terra_framebuffer_create ( &fb, ( size_t ) W, ( size_t ) H ) ) {
        return 2;
    }
    terra_render ( &cam, scene, &fb, 0, 0, ( size_t ) W, ( size_t ) H );

    FILE* out = fopen ( out_path, "w" );
    if ( !out ) {
        perror ( "out" );
        return 2;
    }
    for ( int i = 0; i < W * H; ++i ) {
        const TerraRawIntegrationResult* r = &fb.results[i];
        float n = ( float ) ( r->samples > 0 ? r->samples : 1 );
        fprintf ( out, "%.9g %.9g %.9g\n", r->acc.x / n, r->acc.y / n, r->acc.z / n );
    }
    fclose ( out );
    terra_framebuffer_destroy ( &fb );
    terra_scene_destroy ( scene );
    return 0;
}
